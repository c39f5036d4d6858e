"""Observability: metric logging (TensorBoard-compatible), the alpha/beta
sweep plots, and profiling helpers."""

from protoclip_tpu_torch.obs.logging import MetricLogger
from protoclip_tpu_torch.obs.profiler import timed, trace_to

__all__ = ["MetricLogger", "timed", "trace_to"]
