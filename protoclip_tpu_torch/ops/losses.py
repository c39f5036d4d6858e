"""Proto-CLIP's loss stack (counterpart of ``protoclip_tpu/ops/losses.py``;
ref ``utils.py:72-109``), all in fp32.

- L1: NLL of the mixed probability ``p`` against the episode labels.
- L2: InfoNCE(image prototypes, text prototypes), image-to-text alignment.
- L3: InfoNCE(text prototypes, image prototypes), text-to-image alignment.
- L4 / L5: self-InfoNCE of each modality (inter-cluster separation).

InfoNCE follows the ``info-nce-pytorch`` defaults the reference uses
(``utils.py:72-77``): L2-normalize query and keys, logits = q @ k^T / 0.1,
positives on the diagonal, mean cross-entropy.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from protoclip_tpu_torch.ops.proto import l2_normalize

INFO_NCE_TEMPERATURE = 0.1


def nll_of_probs(p: torch.Tensor, labels: torch.Tensor, weights: Optional[torch.Tensor] = None,
                 eps: float = 0.0) -> torch.Tensor:
    """Mean negative log of ``p[i, labels[i]]`` (torch ``NLLLoss(log(p))``).

    ``weights`` (0/1 per query) masks the padded query rows of a fixed-shape
    episode: they contribute nothing, and their mean is over the weight sum.
    """
    picked = torch.gather(p.float(), -1, labels.long()[:, None])[:, 0]
    if weights is None:
        return (-torch.log(picked + eps)).mean()
    w = weights.float()
    # Mask the input of the log as well as its output: with only
    # where(w > 0, -log(picked), 0), a padded row whose probability
    # underflowed to 0 keeps log(0) = -inf in the graph, and its backward is
    # 0 * inf = NaN in every parameter (seen at beta >= ~26).
    keep = w > 0
    safe = torch.where(keep, picked, torch.ones_like(picked))
    logs = torch.where(keep, -torch.log(safe + eps), torch.zeros_like(picked))
    return torch.sum(logs * w) / torch.clamp_min(torch.sum(w), 1.0)


def info_nce(query: torch.Tensor, keys: torch.Tensor,
             temperature: float = INFO_NCE_TEMPERATURE) -> torch.Tensor:
    """InfoNCE with in-batch negatives; the positives are the aligned rows.

    ``eps`` guards zero rows: the all-zero placeholder visual bank of
    text-only operation gives zero prototypes, and 0/0 would make the loss
    NaN; for unit-norm prototypes max(norm, eps) == norm."""
    qn = l2_normalize(query.float(), eps=1e-12)
    kn = l2_normalize(keys.float(), eps=1e-12)
    logp = torch.log_softmax((qn @ kn.T) / temperature, dim=-1)
    return -torch.diagonal(logp).mean()


def protoclip_loss(p: torch.Tensor, labels: torch.Tensor, img_protos: torch.Tensor,
                   text_protos: torch.Tensor, losses: Sequence[str] = ("L1", "L2", "L3"),
                   query_weights: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """The total Proto-CLIP loss and each enabled term (ref ``utils.py:80-109``),
    keyed L1-L5 as the reference's TensorBoard scalars (``main.py:287-302``),
    plus ``total``.  An empty ``losses`` means L1 alone."""
    terms: Dict[str, torch.Tensor] = {}
    total = torch.zeros((), dtype=torch.float32, device=p.device)
    if len(losses) == 0 or "L1" in losses:
        terms["L1"] = nll_of_probs(p, labels, query_weights)
        total = total + terms["L1"]
    if "L2" in losses:
        terms["L2"] = info_nce(img_protos, text_protos)
        total = total + terms["L2"]
    if "L3" in losses:
        terms["L3"] = info_nce(text_protos, img_protos)
        total = total + terms["L3"]
    if "L4" in losses:
        terms["L4"] = info_nce(img_protos, img_protos)
        terms["L5"] = info_nce(text_protos, text_protos)
        total = total + terms["L4"] + terms["L5"]
    terms["total"] = total
    return terms
