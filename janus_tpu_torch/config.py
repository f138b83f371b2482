"""Global configuration helpers.

The port of ``janus_tpu/config.py``. The solvers are dtype-polymorphic (they
work in the dtype of y0); what the reference's x64 flag switches is the
dtype that new floating arrays get, which in torch is the default floating
dtype. Tight tolerances (rtol below ~1e-8) need float64.
"""

import torch


def enable_x64(on: bool = True) -> None:
    """Make float64 (``on``) or float32 torch's default floating dtype."""
    torch.set_default_dtype(torch.float64 if on else torch.float32)


def default_dtype() -> torch.dtype:
    """torch's default floating dtype: float64 after ``enable_x64()``."""
    return torch.get_default_dtype()
