"""Checkpoints for the NN-training workflows, on ``torch.save``.

The port of ``janus_tpu/utils/checkpoint.py``, which wraps orbax's
``CheckpointManager``. The layout is the manager's: one directory a step
under ``path`` (``path/<step>/tree.pt``), so that several steps live side by
side and ``step=None`` restores the latest. A tree is made of tensors,
Python scalars, None, lists, tuples and dicts; a ``torch.optim`` state dict
is one. Files are read back with ``torch.load(weights_only=True)``, which
unpickles nothing but those types.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Optional

import torch

from janus_tpu_torch.solve.common import tree_map

_FILE = "tree.pt"


def _steps(path: Path):
    return sorted(int(p.name) for p in path.iterdir()
                  if p.name.isdigit() and (p / _FILE).is_file())


def save_checkpoint(path, tree: Any, step: int = 0) -> None:
    """Write ``tree`` as step ``step`` under ``path`` (created if missing).
    The file is written beside its final name and renamed into place, so a
    reader never sees half of it."""
    step_dir = Path(path).resolve() / str(int(step))
    step_dir.mkdir(parents=True, exist_ok=True)
    tmp = step_dir / f".{_FILE}.{os.getpid()}.tmp"
    torch.save(tree, tmp)
    os.replace(tmp, step_dir / _FILE)


def _structure(tree):
    return tree_map(lambda leaf: None, tree)


def restore_checkpoint(path, template: Any = None,
                       step: Optional[int] = None):
    """The tree saved as ``step`` under ``path`` (``None``: the latest step).
    With a ``template`` of the same structure, each tensor goes to the
    template leaf's device and dtype; without one, tensors come back on the
    device they were saved from."""
    path = Path(path).resolve()
    if step is None:
        steps = _steps(path) if path.is_dir() else []
        if not steps:
            raise FileNotFoundError(f"no checkpoint under {path}")
        step = steps[-1]
    file = path / str(int(step)) / _FILE
    if template is None:
        return torch.load(file, weights_only=True)
    tree = torch.load(file, map_location="cpu", weights_only=True)
    if _structure(tree) != _structure(template):
        raise ValueError(f"checkpoint {file} does not have the template's "
                         "structure")

    def place(leaf, like):
        if isinstance(leaf, torch.Tensor) and isinstance(like, torch.Tensor):
            return leaf.to(device=like.device, dtype=like.dtype)
        return leaf

    return tree_map(place, tree, template)
