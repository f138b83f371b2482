"""janus_tpu_torch.native, the port's own binding of native/janus_native.cpp,
against scipy, the port's solve_ivp and the reference's binding (twins of
tests/test_native.py).

The port builds its library under janus_tpu_torch/_build/ and never writes
native/libjanus_native.so, which the reference's tests build (at the same
time in another worker). To hold the reference's Python binding against the
port's without building that file, the reference module is given the port's
loaded library: the same C source, so the same functions and file format.
"""

import numpy as np
import pytest
import torch
from scipy.integrate import solve_ivp as scipy_ivp

from janus_tpu import native as jnative
from janus_tpu_torch import native
from janus_tpu_torch.models.problems import vdp_rhs
from janus_tpu_torch.solve import solve_ivp


@pytest.fixture
def reference_binding(monkeypatch):
    monkeypatch.setattr(jnative, "_lib", native.load())
    return jnative


def test_native_builds_and_solves_vdp():
    y, stats = native.radau5_cpu(native.RHS_VDP, 0.0, 2.0, [2.0, 0.0],
                                 [1000.0], rtol=1e-8, atol=1e-11)
    ref = scipy_ivp(lambda t, yy: [yy[1], 1000.0 * (1 - yy[0] ** 2) * yy[1]
                                   - yy[0]],
                    (0.0, 2.0), [2.0, 0.0], method="Radau", rtol=1e-10,
                    atol=1e-13)
    np.testing.assert_allclose(y, ref.y[:, -1], rtol=1e-6, atol=1e-8)
    assert stats["naccept"] > 0 and stats["nfev"] > stats["naccept"]


def test_native_vs_port_solver_consistency():
    mu = 100.0
    ynat, _ = native.radau5_cpu(native.RHS_VDP, 0.0, 5.0, [2.0, 0.0], [mu],
                                rtol=1e-9, atol=1e-12)
    sol = solve_ivp(vdp_rhs, (0.0, 5.0),
                    torch.tensor([[2.0, 0.0]], dtype=torch.float64),
                    method="radau", args=mu, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(sol.y[0].numpy(), ynat, rtol=1e-6, atol=1e-8)


def test_oracle_equals_the_reference_binding(reference_binding):
    y0 = np.array([2.0, 0.0])
    got = native.radau5_cpu(native.RHS_VDP, 0.0, 1.0, y0, [30.0])
    want = reference_binding.radau5_cpu(reference_binding.RHS_VDP, 0.0, 1.0,
                                        y0, [30.0])
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    np.testing.assert_array_equal(y0, [2.0, 0.0])     # y0 is never written


def test_traj_io_roundtrip(tmp_path):
    data = np.random.default_rng(0).standard_normal((64, 7))
    path = tmp_path / "ds.jtrj"
    native.traj_write(path, data)
    np.testing.assert_array_equal(native.traj_read(path), data)
    with pytest.raises(ValueError):
        native.traj_write(path, data[0])


def test_traj_io_rejects_garbage(tmp_path):
    p = tmp_path / "bad.jtrj"
    p.write_bytes(b"not a dataset")
    with pytest.raises(RuntimeError):
        native.traj_read(p)


def test_each_package_reads_the_others_files(tmp_path, reference_binding):
    data = np.random.default_rng(1).standard_normal((33, 5))
    reference_binding.traj_write(tmp_path / "from_ref.jtrj", data)
    np.testing.assert_array_equal(native.traj_read(tmp_path / "from_ref.jtrj"),
                                  data)
    native.traj_write(tmp_path / "from_port.jtrj", -data)
    np.testing.assert_array_equal(
        reference_binding.traj_read(tmp_path / "from_port.jtrj"), -data)


def test_library_lives_in_the_port_build_dir_and_a_failed_build_raises(
        tmp_path, monkeypatch):
    path = native.build()
    assert path.parent == native.BUILD_DIR and path.exists()
    assert native.build() == path                     # cached
    assert path.name != "libjanus_native.so"
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
    assert not any((tmp_path / "build").glob("*.so"))
