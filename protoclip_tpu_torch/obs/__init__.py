"""Observability: metric logging (TensorBoard-compatible), the alpha/beta
sweep plots, and profiling helpers and spans."""

from protoclip_tpu_torch.obs.logging import MetricLogger
from protoclip_tpu_torch.obs.profiler import span, timed, trace_to

__all__ = ["MetricLogger", "span", "timed", "trace_to"]
