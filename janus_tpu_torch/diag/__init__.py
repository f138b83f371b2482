"""Diagnostics: per-step playback logs (``Options(record_steps=K)``,
``Solution.dyn``)."""

from janus_tpu_torch.diag.record import DYN_FIELDS, init_dyn, record_step

__all__ = ["init_dyn", "record_step", "DYN_FIELDS"]
