"""Kernel J: the vanishing-point detector's sequential multi-model
RANSAC over every image in one launch.

Per image (its lines a contiguous range of the flat inputs, ``offsets``
[I + 1]): the hypotheses ``vp_h = unit(coords[ia[h]] x coords[ib[h]])``
(``ok`` when both lines are valid and the cross product is not zero),
the inlier test ``dist(h, n) <= th``
of every (hypothesis, valid line) pair, then ``max_vps`` rounds of: the
count of each ok hypothesis's inliers among the lines not yet taken (-1
for a hypothesis that is not ok), the first best, and, when it has at
least ``min_supports`` inliers, its refit (the eigenvector of the least
eigenvalue of the moment matrix sum c c^T over its inliers' coords, in
float64, its largest-magnitude component made positive), the inliers'
label and their removal.  The refit is in float64 because the moment
matrix of homogeneous pixel lines is ill-conditioned: a float32
eigensolver, as the JAX package uses, errs by up to ~1e-3 on a VP.  A
round that accepts nothing ends the image: nothing changes after it, so
every later round would accept nothing too.

Inputs: coords [N, 3], mids [N, 2], starts [N, 2] float32, valid [N]
bool, offsets [I + 1] int64, ia / ib [I, H] int32 (line indices within
the image).  Outputs: labels [N] int32 (-1 unlabelled), vps [I, max_vps,
3] float32 (zero past n_found) and n_found [I] int32.

CUDA tensors launch ``csrc/vp_detect.cu``; CPU tensors take
:func:`detect_plain`.  Both compute the hypotheses and the distances in
the same order of correctly rounded fp32 operations, so the inlier
tests, the counts, the labels and ``n_found`` agree bit for bit; the
refit sums the moments in another order (the kernel: threads, then xor
butterflies, then warps in order) and solves the 3 x 3 by Jacobi
rotations where the plain version calls ``torch.linalg.eigh``, both in
float64, so the VPs agree to float32 rounding.
"""

from __future__ import annotations

import ctypes

import torch

from limap_tpu_torch.ops.cuda_build import check_tensor

SOURCE = "vp_detect.cu"
EPS = 1e-12
# dynamic shared memory a block may take; an image whose inlier bit mask
# does not fit below it keeps the mask in global scratch
SHARED_LIMIT = 220 * 1024


def cross3(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """p x q over the last axis, each product and difference rounded."""
    return torch.stack([p[..., 1] * q[..., 2] - p[..., 2] * q[..., 1],
                        p[..., 2] * q[..., 0] - p[..., 0] * q[..., 2],
                        p[..., 0] * q[..., 1] - p[..., 1] * q[..., 0]], -1)


def hypotheses(coords, valid, ia, ib):
    """VP hypotheses [H, 3] of one image and whether each is ok [H]: both
    lines valid and not the same line (a zero cross product would put
    every line through its "VP")."""
    ia, ib = ia.long(), ib.long()
    v = cross3(coords[ia], coords[ib])
    n = torch.sqrt(v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1] + v[:, 2] * v[:, 2])
    return v / (n + EPS)[:, None], valid[ia] & valid[ib] & (n > 0)


def vp_line_distance(vps: torch.Tensor, mids: torch.Tensor,
                     endpoints: torch.Tensor) -> torch.Tensor:
    """[H, N]: the distance of each segment's endpoint to the line
    joining each VP with the segment's midpoint."""
    vx, vy, vz = (vps[:, c, None] for c in range(3))
    mx, my = mids[None, :, 0], mids[None, :, 1]
    a = vy - vz * my
    b = vz * mx - vx
    c = vx * my - vy * mx
    denom = torch.sqrt(a * a + b * b + EPS)
    return torch.abs(a * endpoints[None, :, 0] + b * endpoints[None, :, 1]
                     + c) / denom


def sign_normalize(v: torch.Tensor) -> torch.Tensor:
    """``v`` [..., 3] with its largest-magnitude component (the first on
    ties) made positive."""
    k = torch.argmax(v.abs(), dim=-1, keepdim=True)
    s = torch.where(torch.gather(v, -1, k) < 0, -1.0, 1.0)
    return v * s


def detect_image_plain(coords, mids, starts, valid, ia, ib, max_vps,
                       min_supports, inlier_th):
    """One image in torch ops: (labels [N] int32, vps [max_vps, 3],
    n_found)."""
    N = coords.shape[0]
    dev = coords.device
    labels = torch.full((N,), -1, dtype=torch.int32, device=dev)
    vps = torch.zeros((max_vps, 3), dtype=torch.float32, device=dev)
    if N == 0:
        return labels, vps, 0
    hyp, hyp_ok = hypotheses(coords, valid, ia, ib)
    inl_all = (vp_line_distance(hyp, mids, starts) <= inlier_th) \
        & valid[None]
    remaining = valid.clone()
    k = 0
    for _ in range(max_vps):
        inl = inl_all & remaining[None]
        counts = inl.sum(1)
        counts = torch.where(hyp_ok, counts, torch.full_like(counts, -1))
        best = int(torch.argmax(counts))
        if int(counts[best]) < min_supports:
            break
        m = inl[best]
        c = coords[m].double()
        _, vecs = torch.linalg.eigh(c.T @ c)
        vps[k] = sign_normalize(vecs[:, 0]).float()
        labels[m] = k
        remaining &= ~m
        k += 1
    return labels, vps, k


def detect_plain(coords, mids, starts, valid, offsets, ia, ib, max_vps,
                 min_supports, inlier_th):
    """Every image in turn, in torch ops."""
    I = ia.shape[0]
    dev = coords.device
    labels = torch.full((coords.shape[0],), -1, dtype=torch.int32,
                        device=dev)
    vps = torch.zeros((I, max_vps, 3), dtype=torch.float32, device=dev)
    n_found = torch.zeros(I, dtype=torch.int32, device=dev)
    off = offsets.tolist()
    for i in range(I):
        s = slice(off[i], off[i + 1])
        lab, v, k = detect_image_plain(coords[s], mids[s], starts[s],
                                       valid[s], ia[i], ib[i], max_vps,
                                       min_supports, inlier_th)
        labels[s], vps[i], n_found[i] = lab, v, k
    return labels, vps, n_found


def mask_words(offsets: torch.Tensor) -> int:
    """32-bit words of the largest image's inlier bit mask row."""
    n = offsets[1:] - offsets[:-1]
    return int((int(n.max()) + 31) // 32) if len(n) else 0


def shared_bytes(H: int, words: int, mask_in_shared: bool) -> int:
    """The kernel's dynamic shared memory: hypotheses, their flags, the
    remaining and inlier bit rows, and the mask where it fits."""
    return 16 * H + 8 * words + (4 * H * words if mask_in_shared else 0)


def build() -> ctypes.CDLL:
    from limap_tpu_torch.ops.cuda_build import load_library
    lib = load_library(SOURCE)
    ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
    # coords, mids, starts, valid, offsets, ia, ib, I, H, max_vps,
    # min_supports, th, words, scratch, labels, vps, n_found, stream
    lib.vp_detect_launch.argtypes = [ptr] * 7 + [i64] * 4 + [
        ctypes.c_float, i64] + [ptr] * 5
    lib.vp_detect_launch.restype = ctypes.c_int
    return lib


def detect(coords, mids, starts, valid, offsets, ia, ib, max_vps: int,
           min_supports: int, inlier_th: float):
    """(labels [N] int32, vps [I, max_vps, 3], n_found [I] int32) of every
    image (``detect.launches`` counts the kernel's launches)."""
    N = coords.shape[0]
    I, H = ia.shape
    dev = coords.device
    for name, t, dtype, shape in (
            ("coords", coords, torch.float32, (N, 3)),
            ("mids", mids, torch.float32, (N, 2)),
            ("starts", starts, torch.float32, (N, 2)),
            ("valid", valid, torch.bool, (N,)),
            ("offsets", offsets, torch.int64, (I + 1,)),
            ("ia", ia, torch.int32, (I, H)),
            ("ib", ib, torch.int32, (I, H))):
        check_tensor(name, t, dtype, shape, dev)
    if dev.type == "cpu":
        return detect_plain(coords, mids, starts, valid, offsets, ia, ib,
                            max_vps, min_supports, inlier_th)
    if H < 1 or max_vps < 1:
        raise ValueError(f"the kernel takes at least one hypothesis and one "
                         f"round, got H={H}, max_vps={max_vps}")
    labels = torch.empty(N, dtype=torch.int32, device=dev)
    vps = torch.empty((I, max_vps, 3), dtype=torch.float32, device=dev)
    n_found = torch.empty(I, dtype=torch.int32, device=dev)
    if I == 0:
        return labels, vps, n_found
    words = mask_words(offsets)
    scratch = None
    if shared_bytes(H, words, True) > SHARED_LIMIT:
        scratch = torch.empty((I, H, max(words, 1)), dtype=torch.int32,
                              device=dev)
    args = [t.contiguous() for t in (coords, mids, starts, valid, offsets,
                                      ia, ib)]
    with torch.cuda.device(dev):
        err = build().vp_detect_launch(
            *(t.data_ptr() for t in args), I, H, max_vps, min_supports,
            ctypes.c_float(inlier_th), words,
            None if scratch is None else scratch.data_ptr(),
            labels.data_ptr(), vps.data_ptr(), n_found.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"vp_detect launch failed: CUDA error {err}")
    _COUNTER.launches += 1
    return labels, vps, n_found


detect.launches = 0
# the count lives on detect itself, also while a caller has wrapped the
# module's name (chip_smoke records the path's inputs that way)
_COUNTER = detect
