"""Measurements of the port's kernels on a CUDA card (``kernels.py``)."""
