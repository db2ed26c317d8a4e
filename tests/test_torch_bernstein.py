"""Bernstein basis, derivative and featurize of the port against the JAX
package on the same numpy inputs (atol 1e-6: f32 evaluation of the same
formulas; the port builds powers by torch.pow, the reference by jnp.power)."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import bernstein as RB  # noqa: E402
from repro.core import mctm as RM  # noqa: E402
from repro_torch.core import bernstein as TB  # noqa: E402
from repro_torch.core import mctm as TM  # noqa: E402

ATOL = 1e-6


@pytest.mark.parametrize("degree", [0, 1, 6, 10])
def test_design_and_derivative_match_reference(degree):
    rng = np.random.default_rng(degree)
    # out-of-range values on purpose: both sides clip t to [0, 1]
    t = rng.uniform(-0.3, 1.3, size=(257,)).astype(np.float32)
    np.testing.assert_allclose(
        TB.bernstein_design(torch.from_numpy(t), degree).numpy(),
        np.asarray(RB.bernstein_design(jnp.asarray(t), degree)), atol=ATOL,
    )
    np.testing.assert_allclose(
        TB.bernstein_deriv_design(torch.from_numpy(t), degree).numpy(),
        np.asarray(RB.bernstein_deriv_design(jnp.asarray(t), degree)), atol=ATOL,
    )


def test_binomials_and_monotone_theta_match_reference():
    np.testing.assert_array_equal(TB.binomial_coefficients(9), RB.binomial_coefficients(9))
    raw = np.random.default_rng(1).normal(0, 30, size=(3, 7)).astype(np.float32)
    # |x| > 20 on purpose: softplus must be logaddexp(x, 0) there too
    th = TB.monotone_theta(torch.from_numpy(raw)).numpy()
    np.testing.assert_allclose(th, np.asarray(RB.monotone_theta(jnp.asarray(raw))), rtol=1e-6)
    inv = TB.monotone_theta_inverse(torch.from_numpy(th)).numpy()
    np.testing.assert_allclose(
        inv, np.asarray(RB.monotone_theta_inverse(jnp.asarray(th))), rtol=1e-5, atol=1e-5
    )


@pytest.mark.parametrize("n", [1, 300])
def test_basis_features_match_reference_with_clipping(n):
    rng = np.random.default_rng(n)
    Y = rng.normal(size=(n, 2)).astype(np.float32) * 3
    # fitted on a narrower sample: the wider Y partly falls outside and clips
    scaler = RB.DataScaler.fit(rng.normal(size=(50, 2)).astype(np.float32))
    tscaler = TB.DataScaler(low=scaler.low, high=scaler.high)
    cfg, tcfg = RM.MCTMConfig(J=2, degree=6), TM.MCTMConfig(J=2, degree=6)
    A, Ap = RM.basis_features(cfg, scaler, jnp.asarray(Y))
    tA, tAp = TM.basis_features(tcfg, tscaler, torch.from_numpy(Y))
    assert tA.shape == (n, 2, 7) and tAp.shape == (n, 2, 7)
    np.testing.assert_allclose(tA.numpy(), np.asarray(A), atol=ATOL)
    np.testing.assert_allclose(tAp.numpy(), np.asarray(Ap), atol=ATOL)
    np.testing.assert_allclose(
        tscaler.transform(torch.from_numpy(Y)).numpy(),
        np.asarray(scaler.transform(jnp.asarray(Y))), atol=ATOL,
    )


def test_scaler_bounds_upload_once_and_stay_out_of_copies():
    """``DataScaler.bounds`` is made once per scaler, dtype and device; a
    traced call (fake tensors) leaves nothing for later calls, and a pickled
    or copied scaler carries no tensor of the original."""
    import copy
    import pickle

    from torch._subclasses.fake_tensor import FakeTensorMode, is_fake

    Y = np.random.default_rng(3).normal(size=(64, 3))
    s = TB.DataScaler.fit(Y)
    with FakeTensorMode():
        assert is_fake(s.bounds())
    b = s.bounds()
    assert not is_fake(b) and s.bounds() is b
    assert b.dtype == torch.float32 and s.bounds(torch.float64).dtype == torch.float64
    want = np.stack([s.low, s.high, s.inv_span]).astype(np.float32)
    np.testing.assert_array_equal(b.numpy(), want)
    for other in (pickle.loads(pickle.dumps(s)), copy.deepcopy(s)):
        assert "_bounds" not in vars(other)
        assert other.bounds() is not b and torch.equal(other.bounds(), b)
