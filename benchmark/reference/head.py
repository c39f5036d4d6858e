"""The Proto-CLIP head in float64 (Proto-CLIP, arXiv:2307.03073): the
``fc`` query adapter, the visual and textual prototypes, the
alpha/beta mix of the two softmaxes over negative squared distances, and
the top-k with ties in index order."""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

FC_RATIO = 0.2  # the adapter's residual blend: 0.2 * f(x) + 0.8 * x
LN_EPS = 1e-5


def _unit(x: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(eps)


def fc_adapter(state: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """``Linear(d, d/4, bias=False) -> LayerNorm -> Linear(d/4, d,
    bias=False) -> LayerNorm``, blended with its input."""
    s = {k: v.double() for k, v in state.items()}
    h = x @ s["fc.0.weight"].T
    h = F.layer_norm(h, h.shape[-1:], s["fc.1.weight"], s["fc.1.bias"], LN_EPS)
    h = h @ s["fc.2.weight"].T
    h = F.layer_norm(h, h.shape[-1:], s["fc.3.weight"], s["fc.3.bias"], LN_EPS)
    return FC_RATIO * h + (1.0 - FC_RATIO) * x


def probabilities(features: torch.Tensor, bank_v: torch.Tensor, bank_t: torch.Tensor,
                  adapter: Dict[str, torch.Tensor], alpha: float, beta: float,
                  shots: int) -> torch.Tensor:
    """Image features (B, d) -> the mixed class probabilities (B, N)."""
    n_class = bank_t.shape[0]
    q = _unit(fc_adapter(adapter, _unit(features.double())))
    shots_v = _unit(bank_v.double().reshape(n_class, shots, -1), 1e-12)
    proto_img = _unit(shots_v.mean(dim=1), 1e-12)
    proto_txt = _unit(bank_t.double())

    def softmax_of_distances(protos):
        d2 = (q * q).sum(-1, keepdim=True) + (protos * protos).sum(-1) - 2.0 * q @ protos.T
        return torch.softmax(-beta * d2, dim=-1)

    return alpha * softmax_of_distances(proto_img) + (1.0 - alpha) * softmax_of_distances(proto_txt)


def top_k(p: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    values, ids = torch.sort(p, dim=-1, descending=True, stable=True)
    return values[:, :k], ids[:, :k]
