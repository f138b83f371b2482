"""janus_tpu_torch.utils (checkpoints on torch.save) and janus_tpu_torch.config,
against the reference's orbax checkpoints and x64 flag."""

import numpy as np
import pytest
import torch

import janus_tpu.config as jconfig
from janus_tpu.utils import restore_checkpoint as j_restore
from janus_tpu.utils import save_checkpoint as j_save
from janus_tpu_torch import config
from janus_tpu_torch.models.neural import mlp_apply, mlp_init
from janus_tpu_torch.solve.common import tree_leaves
from janus_tpu_torch.utils import restore_checkpoint, save_checkpoint


def _trained_mlp_and_adam():
    """An MLP tree and an Adam state dict after two steps (moments set)."""
    params = mlp_init([2, 8, 1], torch.Generator().manual_seed(0),
                      torch.float64, "cpu")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_()
    opt = torch.optim.Adam(leaves, lr=3e-3)
    x = torch.linspace(-1, 1, 10, dtype=torch.float64).reshape(5, 2)
    for _ in range(2):
        opt.zero_grad()
        mlp_apply(params, x).square().sum().backward()
        opt.step()
    params = {k: [p.detach() for p in v] for k, v in params.items()}
    return params, opt


def _equal_trees(a, b):
    assert type(a) is type(b)
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _equal_trees(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal_trees(x, y)
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.device == b.device
        assert torch.equal(a, b)
    else:
        assert a == b


def test_round_trip_of_an_mlp_and_adam_state_to_the_bit(tmp_path):
    params, opt = _trained_mlp_and_adam()
    tree = {"params": params, "opt": opt.state_dict(), "step": 2,
            "lr": 3e-3, "names": ("w", "b"), "none": None}
    save_checkpoint(tmp_path / "ck", tree, step=2)
    _equal_trees(restore_checkpoint(tmp_path / "ck"), tree)
    _equal_trees(restore_checkpoint(tmp_path / "ck", template=tree), tree)
    # the restored state drives a fresh optimizer
    fresh = [p.clone().requires_grad_() for p in tree_leaves(params)]
    opt2 = torch.optim.Adam(fresh, lr=3e-3)
    opt2.load_state_dict(restore_checkpoint(tmp_path / "ck")["opt"])
    _equal_trees(opt2.state_dict()["state"], opt.state_dict()["state"])


def test_latest_step_and_named_steps(tmp_path):
    for step in (1, 5, 3):
        save_checkpoint(tmp_path, {"x": torch.tensor([float(step)])}, step)
    assert float(restore_checkpoint(tmp_path)["x"]) == 5.0
    assert float(restore_checkpoint(tmp_path, step=1)["x"]) == 1.0
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(tmp_path / "missing")


def test_template_sets_devices_and_dtypes(tmp_path):
    tree = {"a": torch.arange(4, dtype=torch.float64), "b": [torch.ones(2)],
            "n": 7}
    save_checkpoint(tmp_path, tree)
    template = {"a": torch.zeros(4, dtype=torch.float32),
                "b": [torch.zeros(2, dtype=torch.float64, device="meta")],
                "n": 0}
    got = restore_checkpoint(tmp_path, template=template)
    assert got["a"].dtype == torch.float32
    assert torch.equal(got["a"], torch.arange(4, dtype=torch.float32))
    assert got["b"][0].device.type == "meta"
    assert got["b"][0].dtype == torch.float64
    assert got["n"] == 7
    with pytest.raises(ValueError, match="structure"):
        restore_checkpoint(tmp_path, template={"a": template["a"]})


def test_same_tree_as_the_reference_orbax_round_trip(tmp_path):
    params, _ = _trained_mlp_and_adam()
    tree_np = {k: [p.numpy() for p in v] for k, v in params.items()}
    j_save(tmp_path / "jax", tree_np, step=4)
    back_j = j_restore(tmp_path / "jax")
    save_checkpoint(tmp_path / "torch", params, step=4)
    back_t = restore_checkpoint(tmp_path / "torch")
    for k in tree_np:
        for a, b in zip(back_j[k], back_t[k]):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_enable_x64_sets_and_restores_the_default_dtype():
    before = torch.get_default_dtype()
    try:
        config.enable_x64(True)
        assert config.default_dtype() == torch.float64
        assert torch.tensor([1.0]).dtype == torch.float64
        # the reference's tests run with x64 on (tests/conftest.py)
        assert str(jconfig.default_dtype().__name__) == "float64"
        config.enable_x64(False)
        assert config.default_dtype() == torch.float32
        assert torch.zeros(2).dtype == torch.float32
    finally:
        torch.set_default_dtype(before)
