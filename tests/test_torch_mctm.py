"""MCTM likelihood of the port against the JAX package: nll_terms, nll,
loss_parts and log_density at float32 and float64 with the same parameters
carried over by params_from_numpy (rtol 1e-6: the same formulas evaluated
in the same precision; only the summation order of the einsum differs)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import mctm as RM  # noqa: E402
from repro.core.bernstein import DataScaler  # noqa: E402
from repro_torch.core import bernstein as TB  # noqa: E402
from repro_torch.core import mctm as TM  # noqa: E402

RTOL = 1e-6


def _case(J, seed=0):
    rng = np.random.default_rng(seed)
    Y = rng.normal(size=(200, J)) * np.arange(1, J + 1)
    scaler = DataScaler.fit(Y)
    theta = rng.normal(0, 0.5, size=(J, 7))
    lam = rng.normal(0, 0.5, size=(J * (J - 1) // 2,))
    w = rng.uniform(0.5, 2.0, size=200)
    return Y, scaler, theta, lam, w


@pytest.mark.parametrize("J", [1, 3])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_likelihood_matches_reference(J, dtype):
    Y, scaler, theta, lam, w = _case(J, seed=J)
    cfg, tcfg = RM.MCTMConfig(J=J, degree=6), TM.MCTMConfig(J=J, degree=6)
    tscaler = TB.DataScaler(low=scaler.low, high=scaler.high)
    tdt = getattr(torch, dtype)
    with jax.enable_x64(dtype == "float64"):
        jdt = getattr(jnp, dtype)
        params = RM.MCTMParams(jnp.asarray(theta, jdt), jnp.asarray(lam, jdt))
        Yj = jnp.asarray(Y, jdt)
        A, Ap = RM.basis_features(cfg, scaler, Yj)
        ref = {
            "terms": RM.nll_terms(cfg, params, A, Ap),
            "nll": RM.nll(cfg, params, A, Ap, jnp.asarray(w, jdt)),
            "logd": RM.log_density(cfg, params, scaler, Yj),
            **RM.loss_parts(cfg, params, A, Ap, jnp.asarray(w, jdt)),
        }
        ref = {k: np.asarray(v) for k, v in ref.items()}
    tp = TM.params_from_numpy(theta, lam, dtype=tdt, device="cpu")
    Yt = torch.as_tensor(Y, dtype=tdt)
    tA, tAp = TM.basis_features(tcfg, tscaler, Yt)
    assert tA.dtype == tdt
    with torch.no_grad():
        got = {
            "terms": TM.nll_terms(tcfg, tp, tA, tAp),
            "nll": TM.nll(tcfg, tp, tA, tAp, torch.as_tensor(w, dtype=tdt)),
            "logd": TM.log_density(tcfg, tp, tscaler, Yt),
            **TM.loss_parts(tcfg, tp, tA, tAp, torch.as_tensor(w, dtype=tdt)),
        }
    for k, v in ref.items():
        np.testing.assert_allclose(got[k].numpy(), v, rtol=RTOL, atol=0, err_msg=k)


def test_params_roundtrip_and_init_match_reference():
    cfg = RM.MCTMConfig(J=2, degree=6)
    key = jax.random.PRNGKey(3)
    ref = RM.init_params(key, cfg)
    # the reference's jitter draws, recovered from its own key split
    k1, _ = jax.random.split(key)
    normals = np.asarray(jax.random.normal(k1, (2, 7), jnp.float32))
    got = TM.init_params(TM.MCTMConfig(J=2, degree=6), normals=normals, device="cpu")
    th, lam = TM.params_to_numpy(got)
    np.testing.assert_allclose(th, np.asarray(ref.theta_raw), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(lam, np.asarray(ref.lam))
    back = TM.params_to_numpy(TM.params_from_numpy(th, lam, device="cpu"))
    np.testing.assert_array_equal(back[0], th)
    np.testing.assert_array_equal(back[1], lam)
