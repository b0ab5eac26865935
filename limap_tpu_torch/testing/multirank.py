"""Rank workers of the multi-card form, and the spawn that starts them.

``start(fn, world, args)`` starts ``world`` processes
(``torch.multiprocessing``, spawn); each joins one process group through
``parallel.distributed.maybe_initialize`` with a ``file://`` store in a
fresh temporary directory (no port to collide on), runs ``fn(rank,
world, *args)`` on ``threads`` torch and BLAS threads, and pickles its
result there; ``Ranks.join`` returns the results in rank order and
raises if a rank failed or the time ran out.  ``fn`` is one of this
module's functions, so a child imports only the port.

The workers: ``ba_steps`` (the step and the cost over the mesh;
``ba_steps_in_shares`` with O's sums in the card's share order),
``hybrid_ba`` (the driver), ``mapping`` (the host dicts, the image split
and ``triangulate_all_mesh``).  CPU tests run them on gloo; chip_smoke's
phase 17 runs them on the card.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time

import numpy as np
import torch

THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


class Ranks:
    """The running ranks of one ``start``."""

    def __init__(self, ctx, tmp, world):
        self._ctx, self._tmp, self.world = ctx, tmp, world

    def join(self, timeout_s: float = 300.0):
        """Each rank's result, in rank order.  Raises the first failure of
        a rank, or TimeoutError after ``timeout_s`` (the ranks are then
        killed)."""
        deadline = time.monotonic() + timeout_s
        try:
            while not self._ctx.join(timeout=max(
                    0.1, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"{self.world} ranks still running after "
                        f"{timeout_s} s")
            out = []
            for r in range(self.world):
                with open(os.path.join(self._tmp.name, f"{r}.pkl"),
                          "rb") as f:
                    out.append(pickle.load(f))
            return out
        finally:
            for p in self._ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
            self._tmp.cleanup()


def start(fn, world: int, args=(), backend: str = "gloo",
          threads: int = 1) -> Ranks:
    """Start ``fn(rank, world, *args)`` in ``world`` spawned processes of
    one process group (``backend``) on one host."""
    import torch.multiprocessing as mp
    tmp = tempfile.TemporaryDirectory(prefix="multirank")
    env = {v: str(threads) for v in THREAD_VARS}
    # one host: the ranks talk over the loopback interface
    env.update(GLOO_SOCKET_IFNAME="lo", NCCL_SOCKET_IFNAME="lo")
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        ctx = mp.start_processes(
            _entry, args=(fn, world, tmp.name, backend, threads, args),
            nprocs=world, join=False, start_method="spawn")
    except BaseException:
        tmp.cleanup()
        raise
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return Ranks(ctx, tmp, world)


def _entry(rank, fn, world, folder, backend, threads, args):
    import torch.distributed as dist
    from limap_tpu_torch.parallel import distributed as D
    torch.set_num_threads(threads)
    D.maybe_initialize(f"file://{folder}/store", world, rank, backend,
                       timeout_s=120.0)
    try:
        out = fn(rank, world, *args)
        with open(os.path.join(folder, f"{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def _numpy(state):
    return tuple(x.detach().cpu().numpy() for x in state)


def ba_steps(rank, world, problem, runs, device="cpu"):
    """``problem`` (state, line_data, point_data, n_images, n_cameras) as
    numpy tuples; ``runs`` [(name, HybridBAOptions kwargs, steps)].  Each
    run takes its steps from the state over ``make_mesh()``: per step the
    state (numpy) and the step's cost, the cost function at the start and
    at each new state, the collectives (``parallel.mesh.LOG``) and the
    seconds."""
    from limap_tpu_torch.parallel import (HybridBAOptions, HybridBAState,
                                          make_hybrid_ba_cost,
                                          make_hybrid_ba_step, make_mesh)
    from limap_tpu_torch.parallel import mesh as M
    state0, ld, pd, n_images, n_cameras = problem
    mesh = make_mesh()
    dev = torch.device(device)
    ld = tuple(torch.as_tensor(x, device=dev) for x in ld)
    pd = tuple(torch.as_tensor(x, device=dev) for x in pd)
    out = {}
    for name, kw, steps in runs:
        opts = HybridBAOptions(**kw)
        step = make_hybrid_ba_step(mesh, n_images, n_cameras, opts, dev)
        cost = make_hybrid_ba_cost(mesh, opts, dev)
        s = HybridBAState(*(torch.as_tensor(x, device=dev) for x in state0))
        res = {"states": [], "costs": [], "cost_fn": [float(cost(s, ld, pd))]}
        M.LOG.reset()
        t0 = time.perf_counter()
        for _ in range(steps):
            s, c = step(s, ld, pd)
            res["states"].append(_numpy(s))
            res["costs"].append(float(c))
        res["seconds"] = time.perf_counter() - t0
        res["collectives"] = M.LOG.summary()
        res["cost_fn"] += [float(cost(HybridBAState(*(
            torch.as_tensor(x, device=dev) for x in st)), ld, pd))
            for st in res["states"]]
        out[name] = res
    return out


def ba_steps_in_shares(rank, world, problem, runs, share):
    """``ba_steps`` on the CPU with O's g, diag0 and matrix summed in
    shares of ``share`` pairs, as the card's stage 2 adds them
    (``testing/hybrid_checks.py::summed_in_shares``)."""
    from limap_tpu_torch.testing.hybrid_checks import summed_in_shares
    with summed_in_shares(share):
        return ba_steps(rank, world, problem, runs)


def hybrid_ba(rank, world, imagecols, pointtracks, linetracks, opts_kw,
              n_iterations, device="cpu", timed=False):
    """``solve_hybrid_bundle_adjustment`` over ``make_mesh()``: its
    output, the seconds, the collectives and, on the card, the kernels'
    launches by kind (and O's and P's yardsticks', which no path
    launches)."""
    from limap_tpu_torch.ops import hybrid_ba as O
    from limap_tpu_torch.parallel import (HybridBAOptions, make_mesh,
                                          solve_hybrid_bundle_adjustment)
    from limap_tpu_torch.parallel import mesh as M
    O.reset_counts()
    M.LOG.reset()
    M.LOG.timed = timed
    t0 = time.perf_counter()
    out = solve_hybrid_bundle_adjustment(
        imagecols, pointtracks, linetracks, HybridBAOptions(**opts_kw),
        mesh=make_mesh(), n_iterations=n_iterations, device=device)
    secs = time.perf_counter() - t0
    M.LOG.timed = False
    return {"out": out, "seconds": secs, "collectives": M.LOG.summary(),
            "launches": {"hybrid_terms": dict(O.hybrid_terms.counts),
                         "hybrid_apply": dict(O.hybrid_apply.counts),
                         "hybrid_cost": O.hybrid_cost.launches,
                         "hybrid_terms_scan": O.hybrid_terms_scan.launches,
                         "hybrid_apply_scan": O.hybrid_apply_scan.launches}}


def node_tables(tri):
    """A triangulator's per-node results as host arrays (best line, its
    uncertainty and score, the valid edges and their count)."""
    return tuple(np.asarray(x) for x in tri.host_state())


def mapping(rank, world, imagecols, segs, matches, cfg, device="cpu"):
    """The image split (``shard_image_ids``), each rank's share of the
    segments and matches merged with ``all_gather_host_dicts``, then
    ``triangulate_all_mesh`` over ``make_mesh()`` (its node tables and
    tracks) and ``run_distributed_mapping`` (its tracks), with F's and G's
    launches and the seconds of each."""
    from limap_tpu_torch.ops import tri_propose, tri_score
    from limap_tpu_torch.parallel import distributed as D
    from limap_tpu_torch.parallel import make_mesh
    from limap_tpu_torch.triangulation.triangulator import (
        GlobalLineTriangulator, TriangulatorConfig)
    mine = D.shard_image_ids(imagecols.get_img_ids())
    segs_all = D.all_gather_host_dicts({i: segs[i] for i in mine})
    matches_all = D.all_gather_host_dicts({i: matches[i] for i in mine
                                           if i in matches})
    order = D.all_gather_host_dicts({"shared": rank, f"rank {rank}": rank})
    tri_propose.propose.launches = tri_score.score.launches = 0
    t0 = time.perf_counter()
    tri = GlobalLineTriangulator(
        TriangulatorConfig.from_dict(cfg.get("triangulation")), device)
    tri.init(segs_all, imagecols)
    tri.triangulate_all_mesh(matches_all, make_mesh())
    tables = node_tables(tri)
    tracks = tri.compute_line_tracks()
    mesh_s = time.perf_counter() - t0
    launches = {"tri_propose": tri_propose.propose.launches,
                "tri_score": tri_score.score.launches}
    t0 = time.perf_counter()
    mapped = D.run_distributed_mapping(cfg, imagecols, segs_all,
                                       matches_all, device=device)
    return {"mine": mine, "segs_keys": list(segs_all), "order": order,
            "tables": tables, "tracks": tracks, "mapped": mapped,
            "launches": launches, "seconds": {
                "triangulate_all_mesh": mesh_s,
                "run_distributed_mapping": time.perf_counter() - t0}}


def jobs(rank, world, calls):
    """Several workers in one spawn: [(fn, args)] -> their results."""
    return [fn(rank, world, *args) for fn, args in calls]


def two_dim_mesh(rank, world, imagecols, segs, matches, cfg, device="cpu"):
    """``triangulate_all_mesh`` on a (1, world) mesh named (``"hosts"``,
    ``TRACK_AXIS``): without ``axis`` it raises (the message), with
    ``axis=TRACK_AXIS`` it runs on that dimension (the node tables)."""
    from torch.distributed.device_mesh import DeviceMesh
    from limap_tpu_torch.parallel import TRACK_AXIS
    from limap_tpu_torch.triangulation.triangulator import (
        GlobalLineTriangulator, TriangulatorConfig)
    kind = "cuda" if torch.device(device).type == "cuda" else "cpu"
    mesh = DeviceMesh(kind, [list(range(world))],
                      mesh_dim_names=("hosts", TRACK_AXIS))
    tri = GlobalLineTriangulator(
        TriangulatorConfig.from_dict(cfg.get("triangulation")), device)
    tri.init(segs, imagecols)
    try:
        tri.triangulate_all_mesh(matches, mesh)
        refused = None
    except ValueError as e:
        refused = str(e)
    tri.triangulate_all_mesh(matches, mesh, axis=TRACK_AXIS)
    return {"refused": refused, "tables": node_tables(tri)}
