"""The 1-D ``data`` mesh and the multi-process entry point (counterpart of
``protoclip_tpu/parallel/mesh.py``) on ``torch.distributed``.

A :class:`Mesh` lists this process's devices, one per shard of the batch
axis.  A device may appear more than once: several shards on one card, or
an 8-entry mesh of ``cpu`` (the CPU tests' stand-in for the JAX tests' 8
virtual host devices).  With a process group up the mesh spans every
process: each holds the same number of shards, and process ``r`` holds
global shards ``r * n_local`` to ``(r + 1) * n_local - 1``.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import sys
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from protoclip_tpu_torch.device import resolve_device

# a rank that waits on a dead peer fails after this instead of hanging
_TIMEOUT = datetime.timedelta(minutes=5)
_LAUNCHER_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")

# the CUDA devices ``init_distributed`` gave this process (``local_device_ids``
# or ``$LOCAL_RANK``); process-wide, as the process group it belongs to
_local_device_ids: Optional[Tuple[int, ...]] = None


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices``: this process's shards, in order; ``size``: the shards
    of every process; ``offset``: the global index of this process's first
    shard."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...]
    size: int
    offset: int

    @property
    def device(self) -> torch.device:
        """The process's first device: the text encode, the banks, ``P``
        and the trainers' state live there."""
        return self.devices[0]

    @property
    def process_count(self) -> int:
        return self.size // len(self.devices)


def process_device(device=None, mesh: Optional[Mesh] = None) -> torch.device:
    """Where this process keeps what is not sharded: ``device`` (default:
    the card), or with a ``mesh`` its first device (``device``, if given,
    must be that one)."""
    if mesh is None:
        return resolve_device(device)
    if device is not None and torch.device(device) != mesh.device:
        raise ValueError(f"device {device} is not the mesh's first device {mesh.device}")
    return mesh.device


def _group_up() -> bool:
    return dist.is_available() and dist.is_initialized()


def _world() -> Tuple[int, int]:
    """(world size, rank): (1, 0) without a process group."""
    return (dist.get_world_size(), dist.get_rank()) if _group_up() else (1, 0)


def _visible_cuda_devices() -> list:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass devices=[...] (e.g. ['cpu']) to build "
                           "a mesh on the CPU")
    ids = _local_device_ids if _group_up() and _local_device_ids else range(
        torch.cuda.device_count())
    return [torch.device("cuda", i) for i in ids]


def local_device_count() -> int:
    """The CUDA devices this process drives (0 without CUDA)."""
    return len(_visible_cuda_devices()) if torch.cuda.is_available() else 0


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
    backend: Optional[str] = None,
) -> bool:
    """Join this process to a multi-process group (``torch.distributed``).

    Arguments fall back to ``$PROTOCLIP_COORDINATOR`` /
    ``$PROTOCLIP_NUM_PROCESSES`` / ``$PROTOCLIP_PROCESS_ID``.  With none set
    anywhere, the launcher's environment is read in their place
    (``MASTER_ADDR``/``MASTER_PORT``/``RANK``/``WORLD_SIZE``, as ``torchrun``
    sets them); with no launcher either, the process stays alone and a
    diagnostic goes to stderr.  ``coordinator_address`` is ``host:port``
    (TCP rendezvous) or an ``init_method`` URL (``tcp://``, ``file://``).

    ``local_device_ids`` (default: ``$LOCAL_RANK``, where set) are the CUDA
    devices this process drives; the first becomes the current device
    before the group forms.  ``backend`` defaults to NCCL where CUDA is up
    and gloo otherwise.

    Returns True when a multi-process group is (or already was) up, False
    for a single process.  Call it before anything touches CUDA.
    """
    global _local_device_ids

    coordinator_address = coordinator_address or os.environ.get("PROTOCLIP_COORDINATOR")
    if num_processes is None and os.environ.get("PROTOCLIP_NUM_PROCESSES"):
        num_processes = int(os.environ["PROTOCLIP_NUM_PROCESSES"])
    if process_id is None and os.environ.get("PROTOCLIP_PROCESS_ID"):
        process_id = int(os.environ["PROTOCLIP_PROCESS_ID"])
    if _group_up():
        return dist.get_world_size() > 1
    if coordinator_address is None and num_processes is None and process_id is None:
        present = [k for k in _LAUNCHER_ENV if os.environ.get(k)]
        if len(present) < len(_LAUNCHER_ENV):
            # the single-process case, but say so: a launcher whose variables
            # went missing would otherwise run N independent jobs silently
            missing = [k for k in _LAUNCHER_ENV if k not in present]
            print("[protoclip_tpu_torch] multi-process auto-detection found no usable "
                  f"launcher environment (missing {', '.join(missing)}); continuing "
                  "single-process", file=sys.stderr)
            return False
        env = os.environ
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        num_processes, process_id = int(env["WORLD_SIZE"]), int(env["RANK"])
    missing = [
        name
        for name, value in (
            ("coordinator_address ($PROTOCLIP_COORDINATOR)", coordinator_address),
            ("num_processes ($PROTOCLIP_NUM_PROCESSES)", num_processes),
            ("process_id ($PROTOCLIP_PROCESS_ID)", process_id),
        )
        if value is None
    ]
    if missing:
        # a partial spec would fail deep inside the rendezvous; name what is absent
        raise ValueError(
            "init_distributed: explicit cluster config is incomplete — "
            f"missing {', '.join(missing)} (set all three, or none for "
            "launcher auto-detection)"
        )
    if local_device_ids is None and os.environ.get("LOCAL_RANK"):
        local_device_ids = [int(os.environ["LOCAL_RANK"])]
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if local_device_ids and torch.cuda.is_available():
        torch.cuda.set_device(int(local_device_ids[0]))
    init_method = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=init_method, world_size=int(num_processes),
                            rank=int(process_id), timeout=_TIMEOUT)
    _local_device_ids = tuple(int(i) for i in local_device_ids) if local_device_ids else None
    return int(num_processes) > 1


def make_mesh(n_devices: Optional[int] = None, axis_names: Sequence[str] = ("data",),
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over the first ``n_devices`` devices of the whole group.

    ``devices`` lists this process's devices (default: its CUDA devices),
    repeats allowed; ``n_devices`` counts every process's and must divide
    evenly over the processes.  More than exist raises, as in JAX.  Extra
    axis names get size 1.
    """
    if devices is None:
        local = _visible_cuda_devices()
    else:
        local = [torch.device(d) for d in devices]
        local = [torch.device("cuda", torch.cuda.current_device())
                 if d.type == "cuda" and d.index is None else d for d in local]
    if not local:
        raise ValueError("a mesh needs at least one device")
    world, rank = _world()
    available = len(local) * world
    n = n_devices or available
    if n > available:
        raise ValueError(f"requested {n} devices, only {available} available")
    if n % world:
        raise ValueError(f"a mesh of {n} devices does not divide over {world} processes")
    per_process = n // world
    return Mesh(tuple(local[:per_process]), tuple(axis_names), n, rank * per_process)
