"""The Proto-CLIP classifier head: memory banks + adapter + ``P``
(counterpart of ``protoclip_tpu/core/protoclip.py``).

Holds the visual bank ``(N*K, d)``, the textual bank ``(N, d)`` and the
adapter parameters as tensors on one device, and classifies cached
features: the inference path of the zero-shot evaluator and the test sweep.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from protoclip_tpu_torch.device import DeviceLike, resolve_device
from protoclip_tpu_torch.models.adapters import apply_adapter
from protoclip_tpu_torch.ops.proto import class_prototypes, l2_normalize, proto_probs


@dataclasses.dataclass
class ProtoClip:
    """Proto-CLIP state."""

    bank_v: torch.Tensor  # (N*K, d) visual memory bank
    bank_t: torch.Tensor  # (N, d) textual memory bank
    adapter: Dict[str, torch.Tensor]  # adapter params; empty = identity
    adapter_kind: str = "fc"
    shots: int = 16

    @property
    def n_class(self) -> int:
        return self.bank_t.shape[0]

    @property
    def dim(self) -> int:
        return self.bank_t.shape[1]

    @property
    def device(self) -> torch.device:
        return self.bank_t.device

    def prototypes(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(image prototypes, text prototypes), both (N, d) L2-normalized:
        per-shot normalize -> mean -> normalize for the images, normalized
        rows for the text."""
        img = class_prototypes(self.bank_v, self.n_class, self.shots)
        return img, l2_normalize(self.bank_t.float())

    def adapt(self, features: torch.Tensor, normalize: bool = True) -> torch.Tensor:
        """Adapter forward on (B, d) features (a tensor or an array),
        optionally L2-normalized; an empty adapter is the identity."""
        out = _as_tensor(features, self.device, torch.float32)
        if self.adapter:
            out = apply_adapter(self.adapter, out, self.adapter_kind)
        return l2_normalize(out) if normalize else out

    def probs(self, features: torch.Tensor, alpha, beta, adapt: bool = True) -> torch.Tensor:
        """Classify cached CLIP features -> (B, N) mixed probabilities."""
        q = self.adapt(features) if adapt else _as_tensor(features, self.device, torch.float32)
        img_p, txt_p = self.prototypes()
        return proto_probs(q, img_p, txt_p, alpha, beta)


def _as_tensor(x, device: torch.device, dtype=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), device=device, dtype=dtype)


@torch.inference_mode()
def predict(model: ProtoClip, features, alpha: float, beta: float, adapt: bool = True):
    """Top-1 prediction -> (labels (B,), confidences (B,))."""
    p = model.probs(features, alpha, beta, adapt=adapt)
    conf, labels = p.max(dim=-1)
    return labels, conf


@torch.inference_mode()
def accuracy(model: ProtoClip, features, labels, alpha: float, beta: float,
             adapt: bool = True) -> float:
    """Top-1 accuracy over cached features, in [0, 1]."""
    p = model.probs(features, alpha, beta, adapt=adapt)
    labels = _as_tensor(labels, model.device).long()
    return float((p.argmax(dim=-1) == labels).float().mean())


def from_arrays(bank_v: Optional[np.ndarray], bank_t: np.ndarray, adapter_params: Optional[Dict],
                adapter_kind: str, shots: int, device: DeviceLike = None) -> ProtoClip:
    """Build a ProtoClip on ``device`` (default: the card) from host arrays.

    ``bank_v`` may be absent for text-only operation: the zero placeholder
    bank yields uniform visual probabilities, so use alpha=0 for exact
    text-only semantics.  ``adapter_params`` may be ``None``/empty: the
    adapter is then the identity."""
    dev = resolve_device(device)
    bank_t = _as_tensor(bank_t, dev, torch.float32)
    if bank_v is None:
        bank_v = torch.zeros(bank_t.shape[0] * shots, bank_t.shape[1], device=dev)

    def move(tree):
        if isinstance(tree, dict):
            return {k: move(v) for k, v in tree.items()}
        return _as_tensor(tree, dev, torch.float32)

    return ProtoClip(
        bank_v=_as_tensor(bank_v, dev, torch.float32),
        bank_t=bank_t,
        adapter=move(adapter_params or {}),
        adapter_kind=adapter_kind,
        shots=shots,
    )
