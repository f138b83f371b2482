"""Runnable examples of the port, each the twin of the reference's
``examples/<name>.py``: ``python3 -m janus_tpu_torch.examples.<name>``."""
