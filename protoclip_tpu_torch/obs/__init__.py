"""Observability: metric logging (TensorBoard-compatible) and the alpha/beta
sweep plots."""

from protoclip_tpu_torch.obs.logging import MetricLogger

__all__ = ["MetricLogger"]
