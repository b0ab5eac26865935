"""Where the time of ``nn_min_dist`` goes, on one NVIDIA GPU:

    python -m limap_tpu_torch.testing.kernel_variants

1. the rate of ``mma.sync`` alone (``csrc/mma_rate.cu``), in clocks an
   instruction on each of an SM's four tensor cores;
2. the kernel of ``csrc/nn_min_dist.cu`` as it is and with one constant
   or one part changed (row tiles a warp, cloud tiles a step, blocks an
   SM, stage size; a quarter of the epilogue's ORs; no barriers; a
   shuffled cloud), each held to the scalar kernel's result where the
   variant is a correct kernel, and timed between two runs of the scalar
   kernel.  The stripped variants give wrong results on purpose: their
   times say what the part they lack costs.

The inputs have the evaluator's shapes and structure: the protocol
scene's GT cloud (1500 segments x 500 points) and 1462 x 1000 samples on
lines 2 mm off GT segments.  Prints one line a measurement and the
card's name and power limit.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

from limap_tpu_torch.ops import cuda_build
from limap_tpu_torch.ops import nn_distance as nnd
from limap_tpu_torch.testing.synthetic import build_scene, gt_point_cloud

SOURCE = os.path.join(cuda_build.CSRC_DIR, nnd.SOURCE)


def constant(name, value):
    """A substitution that sets ``constexpr int <name>`` to ``value``."""
    with open(SOURCE) as f:
        line = next(x for x in f if x.startswith(f"constexpr int {name} ="))
    old = line.split(";")[0] + ";"
    return old, f"constexpr int {name} = {value};"


def blocks_per_sm(n):
    return ("__launch_bounds__(kFilterThreads, 3)\nnn_filter_kernel",
            f"__launch_bounds__(kFilterThreads, {n})\nnn_filter_kernel")


QUARTER_EPILOGUE = (
    "for (int k = 0; k < 4; ++k) signs[u] |= __float_as_uint(d[u][r][k]);",
    "signs[u] |= __float_as_uint(d[u][r][0]);")
NO_BARRIERS = [("    __syncthreads();\n    const float* stage",
                "    const float* stage"),
               ("    __syncthreads();  // stage c is free", "    //")]
# name -> (substitutions, is it a correct kernel)
VARIANTS = {
    "as committed": ([], True),
    "4 row tiles a warp, 2 blocks an SM": (
        [constant("kRowTiles", 4), blocks_per_sm(2)], True),
    "2 cloud tiles a step": ([constant("kTilesPerStep", 2)], True),
    "8 cloud tiles a step, 2 blocks an SM": (
        [constant("kTilesPerStep", 8), blocks_per_sm(2)], True),
    "512-point stages": ([constant("kChunk", 512)], True),
    "a quarter of the epilogue's ORs": ([QUARTER_EPILOGUE], False),
    "no barriers": (NO_BARRIERS, False),
    "neither": ([QUARTER_EPILOGUE] + NO_BARRIERS, False),
}


def build_variant(index, substitutions):
    """Compile the kernel's source with ``substitutions`` applied;
    returns (library, ptxas' line on the filter kernel)."""
    with open(SOURCE) as f:
        text = f.read()
    for old, new in substitutions:
        if old not in text:
            raise RuntimeError(f"variant text not in the source: {old!r}")
        text = text.replace(old, new)
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    stem = os.path.join(cuda_build.BUILD_DIR, f"variant_{index}")
    with open(stem + ".cu", "w") as f:
        f.write(text)
    proc = subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
                           "-o", stem + ".so", stem + ".cu"],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr}")
    used = [x.split(":", 1)[1].strip() for x in proc.stderr.splitlines()
            if "Used" in x]
    lib = ctypes.CDLL(stem + ".so")
    lib.nn_min_dist_launch.argtypes = \
        nnd.build().nn_min_dist_launch.argtypes
    lib.nn_min_dist_launch.restype = ctypes.c_int
    return lib, used[-1]


def cuda_ms(fn, reps=3):
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def evaluator_like_inputs():
    _, _, _, gt = build_scene(4, 1500, 2, device="cpu")
    gt = np.asarray(gt)
    rng = np.random.default_rng(0)
    ends = gt[rng.permutation(1500)[:1462]] + rng.normal(0, 2e-3,
                                                         (1462, 2, 3))
    t = np.linspace(0, 1, 1000)[None, :, None]
    q = ends[:, None, 0] + t * (ends[:, None, 1] - ends[:, None, 0])
    return (torch.as_tensor(q.reshape(-1, 3).astype(np.float32),
                            device="cuda"),
            torch.as_tensor(gt_point_cloud(gt, 500), device="cuda"))


def mma_rates(sm_clock_hz):
    lib = cuda_build.load_library("mma_rate.cu")
    lib.mma_rate_ms.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                                ctypes.c_int]
    lib.mma_rate_ms.restype = ctypes.c_float
    out = torch.zeros(1, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    iters, per_sm = 20000, 2
    for kind, name in enumerate(["m16n8k8 tf32", "m16n8k4 tf32",
                                 "m16n8k8 f16", "m16n8k16 f16"]):
        ms = lib.mma_rate_ms(kind, out.data_ptr(), sms * per_sm, iters)
        if ms < 0:
            raise RuntimeError("mma_rate failed")
        # 8 warps a block on 4 tensor cores, 8 mma an iteration
        per_core = iters * 8 * (8 // 4) * per_sm
        print(f"[mma] {name}: {ms * 1e-3 * sm_clock_hz / per_core:.2f} "
              f"clocks an instruction and tensor core "
              f"({ms:.3f} ms, {per_core} instructions a core)", flush=True)


def main():
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device visible")
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    mma_rates(float(smi.split(",")[2].split()[0]) * 1e6)

    q, p = evaluator_like_inputs()
    S, M = q.shape[0], p.shape[0]
    reference = nnd.nn_min_dist_scalar(q, p)
    print(f"[scalar] {cuda_ms(lambda: nnd.nn_min_dist_scalar(q, p)):.2f} ms "
          f"at {S} x {M}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    clouds = {"": p, ", cloud shuffled": p[torch.randperm(
        M, device="cuda", generator=gen)].contiguous()}
    for index, (name, (subs, correct)) in enumerate(VARIANTS.items()):
        lib, used = build_variant(index, subs)
        for suffix, cloud in clouds.items():
            if suffix and subs:
                continue
            B, centre, p_max, delta = nnd.prepare_cloud_operand(cloud)
            A, ss, err = nnd.prepare_query_operand(q, centre, p_max)
            # a variant's block may own 512 query rows: pad for it
            more = -A.shape[0] % 512
            A = torch.nn.functional.pad(A, (0, 0, 0, more))
            ss = torch.nn.functional.pad(ss, (0, more))
            err = torch.nn.functional.pad(err, (0, more))
            B = nnd.fragment_order(B)
            out = torch.empty(S, device="cuda")
            confirms = torch.zeros(1, dtype=torch.int64, device="cuda")

            def run():
                confirms.zero_()
                code = lib.nn_min_dist_launch(
                    A.data_ptr(), ss.data_ptr(), err.data_ptr(),
                    delta.data_ptr(), A.shape[0], S, q.data_ptr(),
                    B.data_ptr(), B.shape[0], M, cloud.data_ptr(),
                    out.data_ptr(), confirms.data_ptr(),
                    torch.cuda.current_stream().cuda_stream)
                if code:
                    raise RuntimeError(f"launch failed: CUDA error {code}")

            ms = cuda_ms(run)
            same = torch.equal(out, reference)
            if correct and not same:
                raise RuntimeError(f"variant {name!r} differs from the "
                                   f"scalar kernel")
            print(f"[variant] {name}{suffix}: {ms:.2f} ms; "
                  f"{int(confirms) / S:.1f} confirms a query; "
                  f"equal to scalar: {same}; {used}", flush=True)
    print(f"[scalar] {cuda_ms(lambda: nnd.nn_min_dist_scalar(q, p)):.2f} ms",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
