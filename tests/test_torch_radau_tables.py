"""The port's own copy of the Radau IIA tables equals the reference's.

janus_tpu_torch/solve/radau_tables.py is a numpy-only copy of the
derivation (the reference module cannot be imported without jax). Both run
the same float64 numpy code, so every field agrees to 1e-14.
"""

import numpy as np
import pytest
import torch

from janus_tpu.solve.radau_tables import radau_tableau as ref_tableau
from janus_tpu_torch.solve.radau_tables import radau_tableau

torch.set_num_threads(1)


@pytest.mark.parametrize("s", [1, 3, 5, 7])
def test_tables_match_reference(s):
    got, ref = radau_tableau(s), ref_tableau(s)
    assert got.s == ref.s and got.order == ref.order
    for field in ("c", "a", "b", "mu_real", "mu_complex", "t_mat", "ti_mat",
                  "e", "p"):
        np.testing.assert_allclose(np.asarray(getattr(got, field)),
                                   np.asarray(getattr(ref, field)),
                                   rtol=1e-14, atol=1e-14, err_msg=field)
