"""Proto-CLIP checkpoint triples (``_v.pt`` / ``_t.pt`` / ``_a.pt``) and the
torch-file readers of the port (counterpart of
``protoclip_tpu/io/checkpoint.py``; ``torch.load``/``torch.save`` take the
place of the JAX package's pure-Python ``io/torch_pt.py``).

The reference trainer saves three artifacts on every val-accuracy
improvement (``main.py:350-369``):

- ``*_v.pt`` - the visual memory bank, ``(N*K, d)``
- ``*_t.pt`` - the textual memory bank, ``(N, d)``
- ``*_a.pt`` - the adapter ``state_dict()``

under ``caches/<ds>/models/<backbone>/K-<K>/alpha-beta/<a>-<b>/best_lr_...``.
This module reads and writes that layout, so a triple written by the JAX
package, the reference or the port is read by each of them.  A JAX host
without torch writes ``<path>.npz`` sidecars instead; they are read here
too.
"""

from __future__ import annotations

import collections
import contextlib
import io
import os
import pickle
import uuid
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch


def beautify(name: str) -> str:
    """Backbone name -> path token, e.g. ``ViT-B/16`` -> ``ViT_B_16``
    (the reference's cache naming rule, ``utils.py:276-277``)."""
    return name.strip().replace("/", "_").replace("-", "_")


def model_dir_root(cache_dir: str, backbone: str, shots: int) -> str:
    """``<cache_dir>/models/<backbone>/K-<shots>`` (``utils.py:280-281``)."""
    return os.path.join(cache_dir, "models", beautify(backbone), f"K-{shots}")


def checkpoint_paths(cache_dir: str, backbone: str, shots: int, alpha: float, beta: float,
                     lr: float, augment_epoch: int, train_epoch: int,
                     qt: bool = False) -> Tuple[str, str, str]:
    """Paths of the ``_v/_t/_a`` triple for one operating point.  The
    episodic trainer uses ``alpha-beta/`` (``main.py:352``), the Q^T
    trainer ``best-alpha-beta/`` (``main.qt.py:292``)."""
    subdir = "best-alpha-beta" if qt else "alpha-beta"
    model_dir = os.path.join(model_dir_root(cache_dir, backbone, shots), subdir, f"{alpha}-{beta}")
    prefix = f"best_lr_{lr}_aug_{augment_epoch}_epochs_{train_epoch}"
    return tuple(os.path.join(model_dir, f"{prefix}_{suffix}.pt") for suffix in ("v", "t", "a"))


# -- torch files ------------------------------------------------------------


def _to_numpy(obj: Any) -> Any:
    """Tensors -> numpy arrays (bfloat16 -> float32), containers kept."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if isinstance(obj, dict):
        return {k: _to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_numpy(v) for v in obj)
    return obj


def load_pt(path: str) -> Any:
    """A ``torch.save`` file of tensors or of a dict of tensors -> numpy,
    storages mapped to the CPU; ``weights_only`` admits no other objects."""
    return _to_numpy(torch.load(path, map_location="cpu", weights_only=True))


def _storage_from_bytes(data: bytes):
    # a raw-pickled tensor embeds each storage as a legacy torch.save
    # stream that records the device it was saved from (often 'cuda:0')
    return torch.load(io.BytesIO(data), map_location="cpu", weights_only=True)


def _rebuild_parameter(data, requires_grad, backward_hooks, *state):
    return data


class _RestrictedUnpickler(pickle.Unpickler):
    """Resolves only tensor and storage rebuilders, numpy's data-only
    reconstructors and plain containers: no other callable is reachable."""

    _ALLOWED = {
        ("torch._utils", "_rebuild_tensor_v2"): torch._utils._rebuild_tensor_v2,
        ("torch._utils", "_rebuild_parameter"): _rebuild_parameter,
        ("torch.storage", "_load_from_bytes"): _storage_from_bytes,
        ("collections", "OrderedDict"): collections.OrderedDict,
    }
    _NUMPY_NAMES = ("_reconstruct", "ndarray", "dtype", "scalar", "_frombuffer")
    _BUILTINS = ("list", "tuple", "dict", "set", "frozenset", "int", "float", "complex",
                 "bool", "str", "bytes", "bytearray", "slice", "range")

    def find_class(self, module: str, name: str):
        if (module, name) in self._ALLOWED:
            return self._ALLOWED[(module, name)]
        if module.split(".")[0] == "numpy" and name in self._NUMPY_NAMES:
            return super().find_class(module, name)
        if module == "builtins" and name in self._BUILTINS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"refusing to unpickle {module}.{name}")


def load_pkl(path: str) -> Any:
    """A reference artifact written with plain ``pickle.dump`` -> numpy:
    the textual memory bank (a CUDA tensor, ``utils.py:36-69``) and the
    HP-search grids (``(341, 3)`` arrays, ``main.py:155-211``).  Tensors
    land on the CPU, on hosts without CUDA too."""
    with open(path, "rb") as fh:
        return _to_numpy(_RestrictedUnpickler(fh).load())


# -- the triple -------------------------------------------------------------


def _read_any(path: str):
    """``path`` as a torch file, or the ``<path>.npz`` sidecar that a
    torch-less JAX host writes in its place."""
    npz_path = path + ".npz"
    if not os.path.exists(path) and os.path.exists(npz_path):
        with np.load(npz_path) as z:
            return {k: z[k] for k in z.files}
    return load_pt(path)


def _load_bank(path: str) -> np.ndarray:
    obj = _read_any(path)
    if isinstance(obj, dict):  # state-dict style {'weight': tensor}
        if "weight" in obj:
            obj = obj["weight"]
        elif len(obj) == 1:
            obj = next(iter(obj.values()))
        else:
            raise ValueError(f"{path}: expected a single tensor, got keys {list(obj)}")
    return np.asarray(obj, np.float32)


def load_checkpoint_triple(path_v, path_t: str, path_a
                           ) -> Tuple[Any, np.ndarray, Any]:
    """(visual bank, textual bank, adapter state dict) as fp32 numpy.  The
    visual and adapter paths may be ``None`` (``pretrained_ckpt/``
    snapshots have no ``memory_bank_v.pt``)."""
    bank_v = _load_bank(path_v) if path_v else None
    bank_t = _load_bank(path_t)
    adapter = None
    if path_a:
        state = _read_any(path_a)
        if not isinstance(state, dict):
            raise ValueError(f"{path_a} is not an adapter state dict")
        adapter = {k: np.asarray(v, np.float32) for k, v in state.items()}
    return bank_v, bank_t, adapter


@contextlib.contextmanager
def replace_atomically(path: str) -> Iterator[str]:
    """Yield a tmp name beside ``path`` that only this writer uses, and on
    success rename the file written there onto ``path``: a crash leaves no
    torn file, and the ranks of a mesh run, which write the same files,
    never write into one tmp file.  A leftover tmp file is removed."""
    tmp = f"{path}.tmp-{os.getpid()}-{uuid.uuid4().hex[:8]}"
    try:
        yield tmp
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass


def save_checkpoint_triple(path_v: str, path_t: str, path_a: str, bank_v, bank_t,
                           adapter_state: Dict[str, Any], dtype: str = "float16") -> None:
    """Write a reference-compatible ``_v/_t/_a`` triple with ``torch.save``,
    stored in ``dtype`` (fp16, as the reference's half-precision model
    stores it).  Each file is written through :func:`replace_atomically`,
    and a ``.npz`` sidecar that a torch-less JAX host left at the same path
    is removed, so one generation remains."""
    np_dtype = np.dtype(dtype)

    def tensor(x):
        return torch.from_numpy(np.array(_to_numpy(x), dtype=np_dtype))

    payloads = (
        (path_v, tensor(bank_v)),
        (path_t, tensor(bank_t)),
        (path_a, {k: tensor(v) for k, v in adapter_state.items()}),
    )
    for path, obj in payloads:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with replace_atomically(path) as tmp:
            torch.save(obj, tmp)
        if os.path.exists(path + ".npz"):
            os.remove(path + ".npz")
