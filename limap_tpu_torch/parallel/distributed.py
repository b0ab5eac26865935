"""Multi-process execution: one process a rank, one card a rank.

The reference is single-process.  Here the device stages split over the
ranks of a ``torch.distributed`` process group: the same script runs in
every rank's process, for example under torchrun,

    torchrun --nproc-per-node=N script.py       # one rank a card, NCCL

    from limap_tpu_torch.parallel import distributed as dist
    dist.maybe_initialize()         # no-op when single-process
    mesh = dist.global_mesh()       # 1-D DeviceMesh over every rank
    ... triangulate_all_mesh / solve_hybrid_bundle_adjustment on it ...

Host stages (IO, detection caches) are split with
:func:`shard_image_ids` (each process its contiguous slice of the image
list) and merged with :func:`all_gather_host_dicts`; the device stages
exchange nothing until the summed reduced system of the BA and the
gathered per-node results of the triangulation.

Backend: NCCL when each rank has a card of its own (rank -> card
``LOCAL_RANK``), gloo without CUDA.  NCCL refuses two ranks on one card,
so with more ranks on a host than cards the default raises and the
caller passes ``backend="gloo"`` (the ranks then share the cards,
``LOCAL_RANK`` modulo their count).  Nothing switches the backend by
itself, and a failed initialization raises: there is no single-process
fallback.  Gloo sums CUDA tensors but gathers only host tensors, so
under gloo the gathers of ``parallel/mesh.py`` go through host copies.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from limap_tpu_torch.parallel.mesh import global_mesh


def _env_int(name) -> Optional[int]:
    return int(os.environ[name]) if name in os.environ else None


def default_backend(local_rank: int, local_world: int) -> str:
    """NCCL with a card a rank, gloo without CUDA; raises where NCCL
    would put two ranks on one card."""
    if not torch.cuda.is_available():
        return "gloo"
    n = torch.cuda.device_count()
    if local_world > n or local_rank >= n:
        raise ValueError(
            f"{local_world} ranks on this host and {n} card(s): NCCL "
            "refuses two ranks on one card; pass backend='gloo' for ranks "
            "that share a card")
    return "nccl"


def maybe_initialize(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     timeout_s: Optional[float] = None) -> bool:
    """Initialize the process group when running multi-process.

    Resolution order: explicit arguments, then torch's launcher variables
    (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
    ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``), then single-process (nothing to
    initialize).  ``coordinator_address`` is ``host:port`` or an init URL
    (``tcp://``, ``file://``).  A rank with cards works on card
    ``LOCAL_RANK`` (``process_id`` when unset) modulo their count.
    Raises when the initialization fails.  Returns True when more than one
    process runs."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("RANK")
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if coordinator_address is None and num_processes in (None, 1):
        return False
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError(
            "a multi-process run needs the coordinator's address, the "
            f"number of processes and this one's rank (got "
            f"{coordinator_address!r}, {num_processes}, {process_id})")
    local_rank = _env_int("LOCAL_RANK")
    local_rank = process_id if local_rank is None else local_rank
    local_world = _env_int("LOCAL_WORLD_SIZE") or num_processes
    if backend is None:
        backend = default_backend(local_rank, local_world)
    if torch.cuda.is_available():
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    url = coordinator_address if "://" in coordinator_address \
        else f"tcp://{coordinator_address}"
    kw = {} if timeout_s is None else {"timeout": timedelta(
        seconds=timeout_s)}
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id, **kw)
    return num_processes > 1


def _world():
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def process_info():
    """This process's rank and the world's size; each rank drives one
    device, so the devices are the ranks."""
    rank, world = _world()
    return {"process_index": rank, "process_count": world,
            "local_devices": 1, "global_devices": world}


def shard_image_ids(img_ids: Sequence[int]) -> List[int]:
    """The contiguous slice of images THIS process is responsible for
    (host-side stages: image IO, detection, matching caches)."""
    i, p = _world()
    n = len(img_ids)
    return list(img_ids)[(n * i) // p:(n * (i + 1)) // p]


def all_gather_host_dicts(local: dict) -> dict:
    """Merge per-process host dicts (e.g. {img_id: segments}) across
    processes, in rank order (a later rank's entry wins a shared key).
    Single-process: returns ``local`` unchanged.  The objects are pickled
    across (``dist.all_gather_object``), so every rank sees every image's
    host-side artifacts."""
    _, p = _world()
    if p == 1:
        return local
    parts = [None] * p
    dist.all_gather_object(parts, local)
    merged = {}
    for part in parts:
        merged.update(part)
    return merged


def run_distributed_mapping(cfg: dict, imagecols, all_2d_segs,
                            matches_by_image, ranges=None, mesh=None,
                            device=None):
    """Image-split triangulation and scoring over the mesh's ranks, then
    track building on every rank (the same node tables on every rank, so
    the same tracks, with no exchange).

    Host pre-stages are expected to be split with :func:`shard_image_ids`
    and merged with :func:`all_gather_host_dicts`.  ``mesh`` defaults to
    :func:`global_mesh`."""
    from limap_tpu_torch.triangulation.triangulator import (
        GlobalLineTriangulator, TriangulatorConfig)

    tri = GlobalLineTriangulator(
        TriangulatorConfig.from_dict(cfg.get("triangulation")), device)
    tri.init(all_2d_segs, imagecols)
    if ranges is not None:
        tri.set_ranges(ranges)
    tri.triangulate_all_mesh(matches_by_image,
                             global_mesh() if mesh is None else mesh)
    return tri.compute_line_tracks()
