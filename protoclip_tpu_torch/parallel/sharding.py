"""Placement on a mesh and the sharded encode (counterpart of
``protoclip_tpu/parallel/sharding.py``).

Layout, as in the JAX package:

- CLIP weights, memory banks, adapter, optimizer state: **replicated**.
  The weights are copied once to each distinct device of the mesh
  (:func:`replicated`); the trainable state lives on the process's first
  device.
- Image batches: **sharded on axis 0** over the ``data`` axis.  Every
  process passes the same full global batch and keeps only the rows of its
  own shards (:func:`shard_batch`); the batch must divide evenly over the
  mesh, and the callers round their batch up to a multiple of it.
- Features: **gathered back** in row order onto the process's first device,
  and across processes with ``all_gather`` (:func:`fetch_to_host`, the
  counterpart of ``process_allgather``).

Each shard of the encode runs the same chain as the unsharded encode (on
the card K2, or K3 in the W8A8 mode, through ``ops/kernels.py``).  Every
shard is launched before any result is read back, so the cards overlap.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from protoclip_tpu_torch.models.clip import to_device
from protoclip_tpu_torch.parallel.mesh import Mesh


@dataclasses.dataclass
class ShardedBatch:
    """A global batch of ``rows`` rows as this process's shards, one per
    entry of ``mesh.devices``, each on its device."""

    shards: List[torch.Tensor]
    mesh: Mesh
    rows: int


@dataclasses.dataclass
class Replicas:
    """A tree copied once to each distinct device of ``mesh``."""

    copies: Dict[torch.device, object]
    mesh: Mesh

    def on(self, device: torch.device):
        return self.copies[device]


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Where a value goes on ``mesh``: its batch axis sharded over ``data``
    (``batch=True``) or replicated.  ``put`` places a host value."""

    mesh: Mesh
    batch: bool

    def put(self, value):
        return shard_batch(value, self.mesh) if self.batch else _replicate(value, self.mesh)


def batch_sharding(mesh: Mesh) -> Sharding:
    """Shard axis 0 over the ``data`` mesh axis."""
    return Sharding(mesh, batch=True)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, batch=False)


def _on_device(device):
    """The current CUDA device for launches on ``device`` from any thread
    (the kernel wrappers launch on the current device's stream)."""
    device = torch.device(device)
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def mesh_batch(batch_size: int, mesh: Optional[Mesh]) -> int:
    """``batch_size`` rounded up to a multiple of the mesh's devices (a
    sharded batch must divide evenly; a ragged last batch is padded by the
    encode, ``train.runner.make_encode_fns``)."""
    return batch_size if mesh is None else -(-batch_size // mesh.size) * mesh.size


def _replicate(tree, mesh: Mesh) -> Replicas:
    if isinstance(tree, Replicas) and tree.mesh == mesh:
        return tree
    copies: Dict[torch.device, object] = {}
    for device in mesh.devices:
        if device not in copies:
            copies[device] = to_device(tree, device)
    return Replicas(copies, mesh)


def shard_batch(arr, mesh: Mesh) -> ShardedBatch:
    """Place a full global batch (numpy or tensor) on the mesh, keeping this
    process's shards.  A :class:`ShardedBatch` of ``mesh`` passes through."""
    if isinstance(arr, ShardedBatch) and arr.mesh == mesh:
        return arr
    full = torch.from_numpy(np.ascontiguousarray(arr)) if isinstance(arr, np.ndarray) else arr
    rows = int(full.shape[0])
    if rows % mesh.size:
        raise ValueError(f"a batch of {rows} rows does not divide over a mesh of "
                         f"{mesh.size} devices")
    per = rows // mesh.size
    shards = [full[(mesh.offset + i) * per:(mesh.offset + i + 1) * per].to(device)
              for i, device in enumerate(mesh.devices)]
    return ShardedBatch(shards, mesh, rows)


def _all_gather_rows(local: torch.Tensor) -> torch.Tensor:
    """Every process's ``local`` rows, concatenated in rank order."""
    world = dist.get_world_size()
    if dist.get_backend() == "nccl":  # on the process's card
        buf = local.contiguous()
    else:  # gloo gathers host tensors, as bytes: not every build takes bf16
        buf = local.cpu().contiguous().view(torch.uint8)
    parts = [torch.empty_like(buf) for _ in range(world)]
    dist.all_gather(parts, buf)
    return torch.cat(parts).view(local.dtype).to(local.device)


def gather(batch: ShardedBatch) -> torch.Tensor:
    """The whole global batch in row order on the process's first device."""
    first = batch.mesh.device
    local = torch.cat([s.to(first) for s in batch.shards])
    return _all_gather_rows(local) if batch.mesh.process_count > 1 else local


def fetch_to_host(arr) -> np.ndarray:
    """A host numpy copy of ``arr``: a :class:`ShardedBatch` is gathered
    from every process first."""
    if isinstance(arr, ShardedBatch):
        arr = gather(arr)
    if torch.is_tensor(arr):
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


def make_sharded_encode(encode_fn: Callable, mesh: Mesh) -> Callable:
    """``encode_fn(params, images) -> features`` over ``mesh``: each shard
    runs ``encode_fn`` on its own device with that device's copy of the
    weights (pass :func:`replicated` weights to copy them once, not at
    every call).  Returns the global batch's features in row order on the
    process's first device, the same on every process.  The encode is
    row-local, so each row equals the unsharded encode of that row at the
    same per-shard batch."""

    def encode(params, images) -> torch.Tensor:
        batch = shard_batch(images, mesh)
        weights = _replicate(params, mesh)
        outs = []
        for device, shard in zip(mesh.devices, batch.shards):
            with _on_device(device):
                outs.append(encode_fn(weights.on(device), shard))
        return gather(ShardedBatch(outs, mesh, batch.rows))

    return encode


def shard_qt_step(step_on_features: Callable, encode_fn: Callable, mesh: Mesh) -> Callable:
    """The Q^T step over ``mesh``: ``step(clip_params, images_u8, labels,
    n_valid)`` encodes the global batch sharded, gathers its (B, d) fp32
    features on every process, and runs ``step_on_features(features,
    labels, n_valid)`` (adapter, ``P``, loss, AdamW) replicated on the
    process's first device.  Every process computes the loss of the whole
    global batch (weighted over its ``n_valid`` rows, as JAX's psum does)
    from the same features and labels, so no gradient is all-reduced and
    every process's parameters stay bit-identical.  ``step.encode`` is the
    sharded encode alone (fp32 features, no autograd)."""
    sharded = make_sharded_encode(encode_fn, mesh)

    def encode(clip_params, images_u8) -> torch.Tensor:
        with torch.no_grad():
            return sharded(clip_params, images_u8).float()

    def step(clip_params, images_u8, labels, n_valid: int):
        return step_on_features(encode(clip_params, images_u8), labels, n_valid)

    step.encode = encode
    return step
