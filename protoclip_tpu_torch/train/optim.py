"""The trainers' optimizer (counterpart of ``protoclip_tpu/train/optim.py``).

Reference (``main.py:134-137``): ``AdamW(lr, eps=1e-4, weight_decay=0.05)``
with ``CosineAnnealingLR(T_max=train_epoch * N*K)`` stepped once per epoch,
so the cosine is traversed only ``1 / (N*K)`` of the way: a very gentle
decay.  The learning rate is set on the param group once per epoch from the
closed form :func:`cosine_lr`; ``CosineAnnealingLR``'s recursive update
drifts from it.  torch's AdamW is optax's ``adamw`` step for step: eps is
added to sqrt(v_hat), and the decay is decoupled and scaled by the learning
rate, on every parameter (no mask).
"""

from __future__ import annotations

import math
from typing import Iterable

import torch


def cosine_lr(base_lr: float, epoch: int, t_max: int, eta_min: float = 0.0) -> float:
    """torch ``CosineAnnealingLR``'s value at ``T_cur = epoch``."""
    return eta_min + (base_lr - eta_min) * (1 + math.cos(math.pi * epoch / t_max)) / 2


def make_optimizer(params: Iterable[torch.Tensor], base_lr: float) -> torch.optim.AdamW:
    """AdamW with the reference's hyperparameters over ``params``, in one
    param group."""
    return torch.optim.AdamW(list(params), lr=base_lr, betas=(0.9, 0.999), eps=1e-4,
                             weight_decay=0.05)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr
