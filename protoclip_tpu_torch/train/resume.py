"""Full training-state snapshots: parameters, AdamW's state and the epoch
(counterpart of ``protoclip_tpu/train/resume.py``).

The reference has no optimizer-state or epoch resume; its "resume" is
re-reading the feature caches.  A trainer here snapshots its whole state and
resumes replay-exact: the episodic trainer seeds each epoch's episodes from
``(seed, epoch)`` and the Q^T loader's order and augmentations are functions
of ``(seed, epoch)`` too.

The file is a plain pickle of numpy arrays and plain containers only:
``params`` (the nested parameter dict), ``optimizer`` (per parameter name,
AdamW's ``step``, ``exp_avg`` and ``exp_avg_sq``), ``epoch``, ``kind`` (the
trainer's class name) and ``extra`` (the runner's bookkeeping).  It is read
through the restricted unpickler of ``io/checkpoint.py``, so a tampered
snapshot cannot run code.  A JAX snapshot keys its optimizer state by an
optax tree definition and is not read here.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Tuple

import numpy as np
import torch

from protoclip_tpu_torch.io.checkpoint import load_pkl, replace_atomically
from protoclip_tpu_torch.train.episodic import named_leaves

_MOMENTS = ("exp_avg", "exp_avg_sq")


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def _tree_to_host(tree: Dict) -> Dict:
    return {k: _tree_to_host(v) if isinstance(v, dict) else _host(v) for k, v in tree.items()}


def save_train_state(path: str, trainer, extra: Dict[str, Any] | None = None) -> None:
    """Snapshot a trainer (EpisodicTrainer or QTTrainer) to ``path``,
    atomically (:func:`~protoclip_tpu_torch.io.checkpoint.replace_atomically`).
    ``extra``: a small payload of plain containers the runner wants back on
    resume."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    optimizer: Dict[str, Dict[str, np.ndarray]] = {}
    for name, p in named_leaves(trainer.params):
        st = trainer.optimizer.state.get(p, {})
        optimizer[name] = {
            "step": np.asarray(float(st["step"]) if "step" in st else 0.0, np.float32),
            **{m: _host(st[m]) if m in st else np.zeros(p.shape, np.float32) for m in _MOMENTS},
        }
    state = {
        "params": _tree_to_host(trainer.params),
        "optimizer": optimizer,
        "epoch": int(trainer.epoch),
        "kind": type(trainer).__name__,
        "extra": dict(extra or {}),
    }
    with replace_atomically(path) as tmp, open(tmp, "wb") as fh:
        pickle.dump(state, fh, protocol=pickle.HIGHEST_PROTOCOL)


def _check_like(what: str, saved: np.ndarray, cur: torch.Tensor) -> None:
    if tuple(saved.shape) != tuple(cur.shape):
        raise ValueError(f"{what} shape mismatch: checkpoint {tuple(saved.shape)} vs trainer "
                         f"{tuple(cur.shape)} (different config?)")
    cur_dtype = np.dtype(str(cur.dtype).removeprefix("torch."))
    if saved.dtype != cur_dtype:
        raise ValueError(f"{what} dtype mismatch: checkpoint {saved.dtype} vs trainer "
                         f"{cur_dtype} (different compute_dtype?)")


def load_train_state(path: str, trainer) -> Tuple[int, Dict[str, Any]]:
    """Restore a snapshot into a trainer; returns ``(resume_epoch, extra)``.

    The snapshot must match the trainer's kind, parameter names, and every
    parameter's and moment's shape and dtype, or ``ValueError`` is raised
    before anything changes: a snapshot of another (N, K) split with the
    same N*K rows reshapes into wrong class groups."""
    state = load_pkl(path)
    if state["kind"] != type(trainer).__name__:
        raise ValueError(f"checkpoint is for {state['kind']}, trainer is {type(trainer).__name__}")
    leaves = dict(named_leaves(trainer.params))
    saved = {name: np.asarray(v) for name, v in named_leaves(state["params"])}
    if saved.keys() != leaves.keys():
        raise ValueError("parameter tree structure mismatch (different config?): checkpoint "
                         f"{sorted(saved)} vs trainer {sorted(leaves)}")
    opt = state["optimizer"]
    if opt.keys() != leaves.keys() or any(
            set(v) != {"step", *_MOMENTS} for v in opt.values()):
        raise ValueError("optimizer-state structure mismatch (different optimizer config?)")
    for name, p in leaves.items():
        _check_like(f"parameter {name}", saved[name], p)
        for m in _MOMENTS:
            _check_like(f"optimizer {m} of {name}", np.asarray(opt[name][m]), p)

    with torch.no_grad():
        for name, p in leaves.items():
            p.copy_(torch.from_numpy(saved[name]))
            trainer.optimizer.state[p] = {
                "step": torch.tensor(float(opt[name]["step"]), dtype=torch.float32),
                **{m: torch.from_numpy(np.asarray(opt[name][m])).to(p.device) for m in _MOMENTS},
            }
    trainer.epoch = int(state["epoch"])
    return trainer.epoch, dict(state.get("extra", {}))
