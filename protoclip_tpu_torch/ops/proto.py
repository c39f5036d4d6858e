"""Prototype math and the alpha/beta prototype classifier ``P``
(counterpart of ``protoclip_tpu/ops/proto.py``), all in fp32.

    d^2(q, p_k) = |q|^2 + |p_k|^2 - 2 q.p_k

The ``|q|^2`` term is constant per row and cancels inside the softmax, so
``P = alpha * softmax(beta * (2 q P_img^T - |p|^2)) + (1 - alpha) * (same
for the text prototypes)``: one matrix product and a per-class bias each.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

Scalar = Union[float, torch.Tensor]


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 0.0) -> torch.Tensor:
    """Divide by the L2 norm along ``dim`` in fp32; keeps ``x``'s dtype."""
    xf = x.float()
    norm = torch.linalg.vector_norm(xf, dim=dim, keepdim=True)
    if eps:
        norm = torch.clamp_min(norm, eps)
    return (xf / norm).to(x.dtype)


def class_prototypes(bank: torch.Tensor, n_class: int, k_shots: int) -> torch.Tensor:
    """Visual memory bank (N*K, d) -> L2-normalized class prototypes (N, d):
    per-row normalize, mean over the K shots, normalize again.  ``eps``
    guards the all-zero placeholder bank of text-only operation."""
    zs = l2_normalize(bank.float().reshape(n_class, k_shots, -1), eps=1e-12)
    return l2_normalize(zs.mean(dim=1), eps=1e-12)


def squared_euclidean(q: torch.Tensor, protos: torch.Tensor) -> torch.Tensor:
    """Full pairwise squared Euclidean distances (Q, N), fp32."""
    qf, pf = q.float(), protos.float()
    q_sq = (qf * qf).sum(dim=-1, keepdim=True)
    p_sq = (pf * pf).sum(dim=-1)
    return torch.clamp_min(q_sq + p_sq[None, :] - 2.0 * (qf @ pf.T), 0.0)


def proto_logits(q: torch.Tensor, protos: torch.Tensor) -> torch.Tensor:
    """``2 q.p - |p|^2``: the negative squared distance up to a per-row
    constant, so ``softmax(beta * proto_logits) == softmax(-beta * d^2)``."""
    qf, pf = q.float(), protos.float()
    return 2.0 * (qf @ pf.T) - (pf * pf).sum(dim=-1)[None, :]


def proto_probs(q: torch.Tensor, img_protos: torch.Tensor, text_protos: torch.Tensor,
                alpha: Scalar, beta: Scalar) -> torch.Tensor:
    """The Proto-CLIP classifier ``P``: mixed probabilities (Q, N), fp32."""
    p_img = torch.softmax(beta * proto_logits(q, img_protos), dim=-1)
    p_text = torch.softmax(beta * proto_logits(q, text_protos), dim=-1)
    return alpha * p_img + (1.0 - alpha) * p_text


def proto_predict(q: torch.Tensor, img_protos: torch.Tensor, text_protos: torch.Tensor,
                  alpha: Scalar, beta: Scalar) -> Tuple[torch.Tensor, torch.Tensor]:
    """Argmax class and its probability for each query."""
    p = proto_probs(q, img_protos, text_protos, alpha, beta)
    conf, labels = p.max(dim=-1)
    return labels, conf
