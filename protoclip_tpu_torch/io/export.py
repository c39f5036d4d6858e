"""The canonical serving encode and the serving bundle (counterpart of
``protoclip_tpu/io/export.py``).

A bundle is a directory a serving process loads without the model-building
code path::

    manifest.json     {"format", "backbone", "image_resolution", "batch_size",
                       "batch_sizes", "int8", "normalized", ...}
    params.npz        the flattened parameter tree (path-keyed; bf16 leaves
                      stored as uint16 bit views)

The JAX bundle also holds one StableHLO executable per batch bucket.  Here
the program is the port's own encode, and each bucket becomes one CUDA
graph, captured when the bundle is loaded: the counterpart of one compiled
executable per bucket.  A call copies its rows into the bucket's input
buffer, replays the graph and reads back its rows, so the host issues no
launch of its own.  On the CPU (``device="cpu"``) each bucket is the eager
:func:`make_encode_fn`.

``load_serving_bundle`` also reads the JAX package's v1 and v2 bundles (the
manifest and ``params.npz``, through ``models.clip.params_from_jax``; its
``.shlo`` files are not read).  The JAX package does not read this
format: its tag differs.

Example::

    from protoclip_tpu_torch.io.export import save_serving_bundle, load_serving_bundle
    save_serving_bundle("bundle/", cfg, params, batch_size=256, batch_sizes=(8, 64))
    encode = load_serving_bundle("bundle/")   # (n, H, W, 3) uint8 -> (n, d) fp32
"""

from __future__ import annotations

import json
import math
import os
import threading
import types
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from protoclip_tpu_torch.data.transforms import normalize_batch
from protoclip_tpu_torch.device import DeviceLike, resolve_device
from protoclip_tpu_torch.models.clip import (
    BACKBONE_CONFIGS,
    CLIPConfig,
    encode_image,
    params_from_jax,
    quantize_for_serving,
    to_device,
)
from protoclip_tpu_torch.ops.kernels import launch_counts

FORMAT = "protoclip_tpu_torch.serving_bundle.v1"
# the JAX package's formats: v1 widened ml_dtypes leaves to fp32, v2 stores
# them as bit views (protoclip_tpu/io/export.py:272-283)
JAX_FORMATS = ("protoclip_tpu.serving_bundle.v1", "protoclip_tpu.serving_bundle.v2")
_MANIFEST = "manifest.json"
_PARAMS = "params.npz"
_SEP = "/"  # tree path separator inside the npz


def make_encode_fn(cfg, normalize: bool = True, int8: Optional[bool] = None) -> Callable:
    """``(params, images_u8) -> (B, d) fp32``: ToTensor + Normalize on the
    images' device to bf16, the image tower (K3 in the W8A8 mode, on the
    params' ``blocks_q`` where they carry them; K2 otherwise), fp32 output,
    and an optional L2 normalization (``export.py:116-135``).  ``int8``
    picks the mode (None: ``$PROTOCLIP_INT8``).  The one definition the
    extract CLI and the serving bundle share."""

    @torch.inference_mode()
    def encode(params, images_u8: torch.Tensor) -> torch.Tensor:
        feats = encode_image(params, normalize_batch(images_u8, torch.bfloat16), cfg,
                             int8=int8).float()
        if normalize:
            feats = feats / torch.linalg.norm(feats, dim=-1, keepdim=True)
        return feats

    return encode


# -- the parameter tree in an npz ----------------------------------------------------


def _host_leaf(leaf):
    """(npz-safe array, stored dtype name or None) of one leaf: a torch
    tensor, or a numpy array as the JAX package stores them.  numpy cannot
    hold bfloat16, so bf16 leaves (and ml_dtypes leaves) are stored as
    same-width unsigned-int bit views with their true dtype recorded."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), None
    arr = np.asarray(leaf)
    if arr.dtype.kind == "V":  # an ml_dtypes leaf (bfloat16, fp8, ...)
        return arr.view(np.dtype(f"uint{arr.dtype.itemsize * 8}")), arr.dtype.name
    return arr, None


def _leaves(node, prefix=()):
    if isinstance(node, dict):
        for key, child in node.items():
            yield from _leaves(child, prefix + (str(key),))
    elif isinstance(node, (list, tuple)):
        for i, child in enumerate(node):
            yield from _leaves(child, prefix + (str(i),))
    else:
        yield _SEP.join(prefix), node


def _flatten(params) -> tuple:
    """(path-keyed npz-safe arrays, {path: stored dtype name}) of a tree of
    dicts, lists and tuples whose leaves are tensors or arrays: a bf16
    leaf becomes a uint16 bit view, so the bundle keeps the weights' size."""
    flat, dtypes = {}, {}
    for key, leaf in _leaves(params):
        flat[key], dtype = _host_leaf(leaf)
        if dtype is not None:
            dtypes[key] = dtype
    return flat, dtypes


def _seq_nodes(node, prefix=()) -> dict:
    """{path: "list"|"tuple"} for every sequence node in the tree, recorded
    in the manifest so the loader rebuilds the exact structure: a
    digit-keyed dict stays a dict, and the per-layer block lists come back
    as lists."""
    out: dict = {}
    if isinstance(node, dict):
        items = [(str(k), v) for k, v in node.items()]
    elif isinstance(node, (list, tuple)):
        out[_SEP.join(prefix)] = "tuple" if isinstance(node, tuple) else "list"
        items = [(str(i), v) for i, v in enumerate(node)]
    else:
        return out
    for key, child in items:
        out.update(_seq_nodes(child, prefix + (key,)))
    return out


def _unflatten(flat: dict, seq_nodes: dict):
    """Rebuild the nested tree from path-keyed leaves and the recorded
    sequence-node map (see :func:`_seq_nodes`)."""
    root: dict = {}
    for key, value in flat.items():
        parts = key.split(_SEP)
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value

    def rebuild(node, prefix):
        if not isinstance(node, dict):
            return node
        kind = seq_nodes.get(_SEP.join(prefix))
        if kind:
            seq = [rebuild(node[str(i)], prefix + (str(i),)) for i in range(len(node))]
            return tuple(seq) if kind == "tuple" else seq
        return {k: rebuild(v, prefix + (k,)) for k, v in node.items()}

    return rebuild(root, ())


def _restore(arr: np.ndarray, dtype: Optional[str]) -> torch.Tensor:
    """A stored leaf back to a tensor of its true dtype."""
    if dtype is None:
        return torch.from_numpy(np.array(arr))
    if dtype != "bfloat16":
        raise ValueError(f"serving bundle leaf of dtype {dtype!r}: only bfloat16 is read")
    if arr.dtype.kind == "u":  # the bit view of the current formats
        return torch.from_numpy(np.array(arr).view(np.int16)).view(torch.bfloat16)
    # the JAX package's v1 bundles widened bf16 leaves to fp32: exact back
    return torch.from_numpy(np.asarray(arr, np.float32)).to(torch.bfloat16)


def _without_int8_layers(params: dict) -> dict:
    """The tree without the towers' ``blocks_q``: an int8 bundle quantizes
    its stored weights when it is loaded (``quantize_for_serving``)."""
    return {k: ({kk: vv for kk, vv in v.items() if kk != "blocks_q"} if isinstance(v, dict)
                else v)
            for k, v in params.items()}


# -- save ------------------------------------------------------------------------------


def save_serving_bundle(
    path: str,
    cfg,
    params,
    batch_size: int = 256,
    *,
    batch_sizes: Optional[Sequence[int]] = None,
    int8: bool = False,
    normalize: bool = True,
) -> None:
    """Write a serving bundle for ``cfg``/``params`` with the batch buckets
    ``batch_sizes`` and ``batch_size``, the largest.

    The loader sends each call to the smallest bucket that fits, so an
    underfull call does not pay the largest bucket's compute; per-image
    math is row-local, so a row's features do not depend on its bucket's
    other rows.  ``int8`` makes a W8A8 bundle: the loader quantizes the
    stored weights (``quantize_for_serving``) and every call runs K3, on
    the card or, on the CPU, its plain version; it never falls back to
    bf16.  The towers' int8 layers are not stored.  A bundle holds OpenAI's
    towers: an EVA02-CLIP backbone raises.
    """
    if getattr(cfg, "is_eva", False):
        raise ValueError(f"{cfg.name}: serving bundles hold OpenAI's towers, not EVA02-CLIP's "
                         f"({cfg.vision_block})")
    sizes = sorted({int(batch_size), *(int(b) for b in (batch_sizes or ()))})
    if any(b < 1 for b in sizes):
        raise ValueError(f"batch sizes must be >= 1, got {sizes}")
    if max(sizes) != int(batch_size):
        raise ValueError(
            f"batch_size ({batch_size}) must be the maximum bucket; "
            f"got batch_sizes={sizes}"
        )
    stored = _without_int8_layers(params)
    device = next(leaf.device for _, leaf in _leaves(stored) if isinstance(leaf, torch.Tensor))
    flat, leaf_dtypes = _flatten(stored)
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, _PARAMS), **flat)
    manifest = {
        # a tag of its own: the JAX loader rejects this format loudly
        "format": FORMAT,
        "param_storage": "bitview",
        "backbone": str(cfg.name),
        "backbone_embed_dim": int(cfg.embed_dim),
        "image_resolution": int(cfg.image_resolution),
        "batch_size": int(batch_size),
        "batch_sizes": sizes,
        "int8": bool(int8),
        "normalized": bool(normalize),
        "torch_version": torch.__version__,
        # the card the bundle was written from (None from the CPU); the
        # graphs are captured where it is loaded
        "device_capability": (list(torch.cuda.get_device_capability(device))
                              if device.type == "cuda" else None),
        "param_dtypes": leaf_dtypes,
        "param_seq_nodes": _seq_nodes(stored),
    }
    with open(os.path.join(path, _MANIFEST), "w") as fh:
        json.dump(manifest, fh, indent=1)


# -- load ------------------------------------------------------------------------------


def _params_from_jax_bundle(tree: dict, leaf_dtypes: dict) -> dict:
    """A JAX bundle's tree (stacked block leaves) -> the port's CPU params,
    in bf16 where the bundle stored bf16 leaves, fp32 otherwise."""
    def to_numpy(node):
        if isinstance(node, dict):
            return {k: to_numpy(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [to_numpy(v) for v in node]
        return node.float().numpy() if node.is_floating_point() else node.numpy()

    dtype = torch.bfloat16 if "bfloat16" in leaf_dtypes.values() else torch.float32
    shape = types.SimpleNamespace(is_vit="patch_embed" in tree["visual"])
    return params_from_jax(to_numpy(tree), shape, dtype=dtype, device="cpu")


def _bundle_config(manifest: dict, params: dict) -> CLIPConfig:
    """The registry's config for a registered backbone; a ViT tower's
    architecture otherwise, read from its parameters' shapes (heads by
    CLIP's 64-dims-per-head rule)."""
    name = str(manifest.get("backbone"))
    if name in BACKBONE_CONFIGS:
        return BACKBONE_CONFIGS[name]
    vis, txt = params["visual"], params.get("text")
    if "patch_embed" not in vis:
        raise ValueError(f"serving bundle backbone {name!r} is not registered, and only a "
                         f"ViT tower's architecture can be read from its parameters")
    patch_embed = vis["patch_embed"]
    text = {} if txt is None else dict(
        context_length=int(txt["positional_embedding"].shape[0]),
        vocab_size=int(txt["token_embedding"].shape[0]),
        transformer_width=int(txt["token_embedding"].shape[1]),
        transformer_layers=len(txt["blocks"]),
    )
    return CLIPConfig(
        name, embed_dim=int(vis["proj"].shape[1]),
        image_resolution=int(manifest["image_resolution"]),
        vision_layers=len(vis["blocks"]), vision_width=int(patch_embed.shape[1]),
        vision_patch_size=math.isqrt(int(patch_embed.shape[0]) // 3), **text,
    )


def _launches_since(before: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before[k] for k, v in launch_counts().items() if v != before[k]}


class _EagerBucket:
    """One bucket on the CPU: rows padded with zeros to ``size`` and
    encoded eagerly."""

    graph = None

    def __init__(self, run: Callable, size: int, n_px: int, device: torch.device):
        self.size, self._run, self._n_px, self.device = size, run, n_px, device

    def __call__(self, images_u8: np.ndarray) -> np.ndarray:
        block = np.zeros((self.size, self._n_px, self._n_px, 3), np.uint8)
        block[:len(images_u8)] = images_u8
        feats = self._run(torch.from_numpy(block).to(self.device))
        return feats.cpu().numpy()[:len(images_u8)]


class _GraphBucket:
    """One bucket on the card: a CUDA graph of the encode, captured on
    ``stream`` over a static uint8 input buffer into a static fp32 output,
    after one eager warm-up call (the kernels' library build, the tensor-map
    entry point and the constants' upload happen there, not in the
    capture).  The graph keeps the addresses it captured, so the input,
    the output and every weight stay where they are for the bundle's
    life.  ``launches_per_replay`` holds the launch counters' increments
    during the capture: a replay runs those launches and counts none."""

    def __init__(self, run: Callable, size: int, n_px: int, device: torch.device,
                 pool, stream: torch.cuda.Stream):
        self.size, self.device, self.stream = size, device, stream
        with torch.cuda.device(device):
            self.input = torch.zeros((size, n_px, n_px, 3), dtype=torch.uint8, device=device)
            stream.wait_stream(torch.cuda.current_stream(device))
            before = launch_counts()
            with torch.cuda.stream(stream):
                run(self.input)
            stream.synchronize()
            self.warmup_launches = _launches_since(before)
            before = launch_counts()
            self.graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(self.graph, pool=pool, stream=stream,
                                      capture_error_mode="thread_local"):
                    self.output = run(self.input)
            except Exception as exc:  # no eager fallback on the card
                raise RuntimeError(f"serving bundle: capturing the CUDA graph of bucket {size} "
                                   f"failed: {type(exc).__name__}: {exc}") from exc
            self.launches_per_replay = _launches_since(before)

    def __call__(self, images_u8: np.ndarray) -> np.ndarray:
        n = len(images_u8)
        rows = torch.from_numpy(np.ascontiguousarray(images_u8))
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            self.input[:n].copy_(rows)
            if n < self.size:
                self.input[n:].zero_()
            self.graph.replay()
            return self.output[:n].cpu().numpy()


def load_serving_bundle(path: str, device: DeviceLike = None) -> Callable[[np.ndarray], np.ndarray]:
    """Load a bundle onto ``device`` (default: the card); returns
    ``encode(images_u8) -> (n, d) fp32``.

    Attributes: ``manifest``, ``params`` (on the device), ``cfg``,
    ``device`` and ``artifacts`` (one callable per bucket, largest first
    captured: ``(rows (n <= size, n_px, n_px, 3) uint8) -> (n, d)``; on the
    card each holds its ``graph``, ``input``, ``output`` and
    ``launches_per_replay``).  On the card every bucket is a CUDA graph
    captured here, all sharing one graph memory pool; a capture that fails
    raises with the bucket and the cause."""
    dev = resolve_device(device)
    with open(os.path.join(path, _MANIFEST)) as fh:
        manifest = json.load(fh)
    fmt = manifest.get("format")
    if fmt != FORMAT and fmt not in JAX_FORMATS:
        raise ValueError(f"not a protoclip_tpu serving bundle: {path}")
    sizes = sorted(int(b) for b in manifest.get("batch_sizes", [manifest["batch_size"]]))
    leaf_dtypes = manifest.get("param_dtypes", {})
    with np.load(os.path.join(path, _PARAMS)) as npz:
        flat = {k: _restore(npz[k], leaf_dtypes.get(k)) for k in npz.files}
    params = _unflatten(flat, manifest.get("param_seq_nodes", {}))
    if fmt in JAX_FORMATS:
        params = _params_from_jax_bundle(params, leaf_dtypes)
    cfg = _bundle_config(manifest, params)
    # on the device once: the weights never cross to the card per call
    params = to_device(params, dev)
    int8 = bool(manifest.get("int8"))
    if int8 and "blocks_q" not in params["visual"]:
        params = quantize_for_serving(params)
    encode_fn = make_encode_fn(cfg, normalize=bool(manifest.get("normalized", True)), int8=int8)

    def run(images: torch.Tensor) -> torch.Tensor:
        return encode_fn(params, images)

    batch = max(sizes)
    n_px = int(manifest["image_resolution"])
    artifacts = {}
    if dev.type == "cuda":
        pool = torch.cuda.graph_pool_handle()
        stream = torch.cuda.Stream(device=dev)
        for size in reversed(sizes):
            artifacts[size] = _GraphBucket(run, size, n_px, dev, pool, stream)
    else:
        for size in reversed(sizes):
            artifacts[size] = _EagerBucket(run, size, n_px, dev)
    lock = threading.Lock()  # one call at a time: the buckets' buffers are shared state

    def encode(images_u8: np.ndarray) -> np.ndarray:
        images_u8 = np.asarray(images_u8)
        if images_u8.dtype != np.uint8:
            # reject rather than coerce: float [0,1] pixels would silently
            # truncate to zeros and serve garbage features
            raise ValueError(
                f"bundle expects uint8 pixels (0-255), got {images_u8.dtype}"
            )
        # ndim check before len(): a 0-d input must produce this
        # descriptive ValueError (-> HTTP 400 in cli/serve.py)
        n = images_u8.shape[0] if images_u8.ndim == 4 else 0
        if images_u8.ndim != 4 or images_u8.shape[1:] != (n_px, n_px, 3) or not 1 <= n <= batch:
            raise ValueError(
                f"bundle compiled for (1..{batch}, {n_px}, {n_px}, 3), "
                f"got {images_u8.shape}"
            )
        # the smallest bucket that fits: an underfull call must not pay the
        # largest bucket's compute
        bucket = next(s for s in sizes if s >= n)
        with lock:
            return artifacts[bucket](images_u8)

    encode.manifest = manifest
    encode.params = params
    encode.cfg = cfg
    encode.device = dev
    encode.artifacts = artifacts
    return encode
