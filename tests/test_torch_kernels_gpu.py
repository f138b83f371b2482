"""The CUDA kernels K1/K2 against their plain torch twins, on a CUDA card.

Marked ``gpu``: skips where torch.cuda.is_available() is false. Imports no
jax, so on the GPU machine it runs without the repo's conftest:

    python -m pytest tests/test_torch_kernels_gpu.py --noconftest -q

Shapes: M = 65,536 and a ragged 700, D ∈ {2, 3, 4, 6}; random diagonally
dominant matrices (+5·I). Tolerance, relative to the largest entry of the
twin's result: f64 1e-12, f32 1e-5 (nvcc contracts a − m·b into FMAs).
"""

import numpy as np
import pytest
import torch

from janus_tpu_torch.ops import smalllu


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12),
                                        (torch.float32, 1e-5)])
@pytest.mark.parametrize("m", [65536, 700])
@pytest.mark.parametrize("d", [2, 3, 4, 6])
def test_kernels_match_twins_on_card(d, m, dtype, rtol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(d * 7919 + m)
    a = rng.standard_normal((m, d, d)) + 5.0 * np.eye(d)
    b = rng.standard_normal((m, d))
    a_t = torch.from_numpy(np.ascontiguousarray(
        a.transpose(1, 2, 0).reshape(d * d, m))).to("cuda", dtype)
    b_t = torch.from_numpy(np.ascontiguousarray(b.T)).to("cuda", dtype)
    lu_ref = smalllu.lu_factor_t_ref(a_t)
    launches = (smalllu.lu_factor_t.launches, smalllu.lu_solve_t.launches)
    for got, ref in ((smalllu.lu_factor_t(a_t), lu_ref),
                     (smalllu.lu_solve_t(lu_ref, b_t),
                      smalllu.lu_solve_t_ref(lu_ref, b_t))):
        torch.cuda.synchronize()
        assert float((got - ref).abs().max()) <= rtol * float(ref.abs().max())
    assert (smalllu.lu_factor_t.launches, smalllu.lu_solve_t.launches) == \
        (launches[0] + 1, launches[1] + 1)
