"""Diagnostics: per-step playback logs (``Options(record_steps=K)``,
``Solution.dyn``) and profiler integration (``trace``, ``annotate``,
``scope``, ``device_memory_stats``, ``marginal_seconds``)."""

from janus_tpu_torch.diag.profile import (annotate, device_memory_stats,
                                          marginal_seconds, scope, trace)
from janus_tpu_torch.diag.record import DYN_FIELDS, init_dyn, record_step

__all__ = ["init_dyn", "record_step", "DYN_FIELDS",
           "trace", "annotate", "scope", "device_memory_stats",
           "marginal_seconds"]
