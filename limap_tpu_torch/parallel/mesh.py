"""Meshes of ranks and their collectives: the multi-card form.

JAX lays one program over a ``Mesh`` of devices and sums across it with
``jax.lax.psum`` over a named axis.  Here each card is a rank of a
``torch.distributed`` process group (one process a rank, started by
``torchrun`` or ``testing/multirank.py``; ``parallel/distributed.py``
initializes the group).  The ranks are named in a 1-D ``DeviceMesh``
whose one dimension is ``TRACK_AXIS``, and a ``psum`` becomes an
``all_reduce`` (sum) over that mesh's group.  Tracks (images, for the
triangulation) split over the ranks in contiguous blocks, the r-th block
to the mesh's r-th rank; poses and cameras are on every rank.

Without a process group there is one device, and the one-card path takes
``mesh=None``: ``make_mesh()`` and ``make_mesh(1)`` return None there.

Gloo reduces and broadcasts CUDA tensors but cannot all-gather them:
under gloo a gather goes through host copies of the rows.  NCCL needs a
card a rank.  ``LOG`` counts the collectives issued here (calls and bytes
by kind) and, with ``LOG.timed``, the seconds spent in them (the device
synchronized before and after each; off by default, since the
synchronization costs the overlap of host and device).
"""

from __future__ import annotations

import time
from collections import Counter
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

TRACK_AXIS = "tracks"


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence[int]] = None):
    """1-D ``DeviceMesh`` over the ranks of the initialized process group,
    its one dimension named ``TRACK_AXIS``; device type ``cuda`` when the
    ranks hold cards, ``cpu`` otherwise.  ``n_devices`` (or ``devices``,
    the ranks 0, 1, ... in order) must cover the world: a mesh never
    leaves a rank out, and the r-th block of tracks is rank r's.
    Without a process group: None (the one-card path) for no count or a
    count of 1."""
    n = len(devices) if devices is not None else n_devices
    if not dist.is_initialized():
        if n not in (None, 1):
            raise ValueError(
                f"a mesh of {n} devices needs a process group of {n} ranks "
                "(parallel.distributed.maybe_initialize in each rank's "
                "process)")
        return None
    world = dist.get_world_size()
    if n is not None and n != world:
        raise ValueError(f"a mesh of {n} devices in a world of {world} "
                         "ranks: the mesh spans every rank")
    if devices is not None and [int(r) for r in devices] != list(
            range(world)):
        raise ValueError(f"devices {list(devices)} must be the ranks 0 to "
                         f"{world - 1} in order")
    return global_mesh()


def global_mesh(axis: str = TRACK_AXIS):
    """1-D ``DeviceMesh`` over every rank of every process, its one
    dimension named ``axis`` (None, the one-card path, without a process
    group)."""
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        return None
    kind = "cuda" if torch.cuda.is_available() else "cpu"
    return DeviceMesh(kind, list(range(dist.get_world_size())),
                      mesh_dim_names=(axis,))


def track_sharding(mesh):
    """The placement of track-leading arrays: split in blocks over the
    mesh's one dimension (JAX's ``P(TRACK_AXIS)``)."""
    from torch.distributed.tensor import Shard
    return (Shard(0),)


def replicated(mesh):
    """The placement of poses and cameras: the same on every rank (JAX's
    ``P()``)."""
    from torch.distributed.tensor import Replicate
    return (Replicate(),)


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def is_rank_mesh(mesh) -> bool:
    from torch.distributed.device_mesh import DeviceMesh
    return isinstance(mesh, DeviceMesh)


def mesh_size(mesh) -> int:
    """Devices a ``mesh`` describes: None (one), a count, a
    ``DeviceMesh`` (its ranks), an object with ``devices`` (an array of
    devices, as a JAX mesh has) or a list of devices."""
    if mesh is None:
        return 1
    if is_rank_mesh(mesh):
        return mesh.size()
    if isinstance(mesh, (int, np.integer)):
        return int(mesh)
    if hasattr(mesh, "devices"):
        return int(np.size(mesh.devices))
    return len(mesh)


def rank_mesh(mesh, axis: Optional[str] = None):
    """The 1-D ``DeviceMesh`` of the multi-card form (``axis`` picks one
    dimension of a larger mesh), or None for the one-card path: None, or
    a mesh that describes one device.  A count or a device list of more
    than one is no mesh of ranks and raises, as does a mesh of more than
    one dimension without ``axis``."""
    if is_rank_mesh(mesh):
        if axis is not None and mesh.mesh_dim_names != (axis,):
            mesh = mesh[axis]
        if mesh.ndim != 1:
            raise ValueError(f"a 1-D mesh is needed, got dimensions "
                             f"{mesh.mesh_dim_names}; pass axis=")
        return mesh
    n = mesh_size(mesh)
    if n != 1:
        raise ValueError(
            f"a mesh of {n} devices runs as {n} ranks of a process group, "
            "one process a rank: pass parallel.make_mesh() from an "
            "initialized group (parallel.distributed.maybe_initialize)")
    return None


def block(n: int, mesh) -> slice:
    """The mesh rank's contiguous block of ``n`` rows (``n`` a multiple
    of the mesh's size)."""
    d = mesh.size()
    if n % d:
        raise ValueError(f"{n} rows do not split over {d} ranks: pad them "
                         f"to a multiple of {d}")
    m = n // d
    r = dist.get_rank(mesh.get_group())
    return slice(r * m, (r + 1) * m)


class CollectiveLog:
    """Calls and bytes of the collectives issued through this module, by
    kind (``all_reduce``, ``all_gather``; bytes: the collective's result
    on one rank), and with ``timed`` the seconds spent in them."""

    def __init__(self):
        self.timed = False
        self.reset()

    def reset(self):
        self.calls = Counter()
        self.bytes = Counter()
        self.seconds = 0.0

    def summary(self) -> dict:
        return {"calls": dict(self.calls), "bytes": dict(self.bytes),
                "seconds": self.seconds}


LOG = CollectiveLog()


def _sync(t: torch.Tensor):
    if LOG.timed and t.is_cuda:
        torch.cuda.synchronize(t.device)


def _record(kind: str, t: torch.Tensor, nbytes: int, t0: float):
    _sync(t)
    LOG.calls[kind] += 1
    LOG.bytes[kind] += nbytes
    if LOG.timed:
        LOG.seconds += time.perf_counter() - t0


def _flat(tensors):
    dtype = tensors[0].dtype
    if any(t.dtype != dtype for t in tensors):
        raise ValueError("a collective packs tensors of one dtype")
    return torch.cat([t.reshape(-1) for t in tensors])


def all_reduce_sum(tensors, mesh):
    """Each tensor summed over the mesh's ranks (``psum``), in one
    ``all_reduce`` of their concatenation.  Every rank gets the same
    numbers: each element is added up once and the sum copied out."""
    flat = _flat(tensors)
    _sync(flat)
    t0 = time.perf_counter()
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.get_group())
    _record("all_reduce", flat, flat.numel() * flat.element_size(), t0)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].reshape(t.shape))
        at += t.numel()
    return out


def all_gather_rows(tensors, mesh):
    """Each rank's row block of every tensor (equal blocks on all ranks),
    gathered in the mesh's rank order into the whole tensors, in one
    ``all_gather`` of their concatenation.  Under gloo a CUDA tensor goes
    through a host copy (gloo gathers no CUDA tensor)."""
    flat = _flat(tensors)
    _sync(flat)
    t0 = time.perf_counter()
    group = mesh.get_group()
    host = flat.is_cuda and dist.get_backend(group) == "gloo"
    send = flat.cpu() if host else flat
    parts = [torch.empty_like(send) for _ in range(mesh.size())]
    dist.all_gather(parts, send, group=group)
    parts = [p.to(flat.device) for p in parts] if host else parts
    _record("all_gather", parts[0],
            len(parts) * flat.numel() * flat.element_size(), t0)
    out = [[] for _ in tensors]
    for p in parts:
        at = 0
        for i, t in enumerate(tensors):
            out[i].append(p[at:at + t.numel()].reshape(t.shape))
            at += t.numel()
    return [torch.cat(o) for o in out]
