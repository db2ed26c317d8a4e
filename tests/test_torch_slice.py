"""The whole Algorithm 1 slice of the port — build_coreset →
fit_mctm_streaming (full data and coreset) → streamed_nll →
coreset_epsilon → likelihood_ratio — against the same composition of the
JAX package's single-host calls, at n = 3,001, chunk 1,000, k = 200, 30
adam steps. The port gets the reference's random plans (sketch, hull
normals, sample draw, initial parameters); ε̂ and the ratio agree within
1e-4 absolute (measured: ≤ 3e-5 and ≤ 3e-6 — a few tied hull points and
the f32 leverage of the degree-6 Gram move the weights by ~1e-3)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import coreset as RC  # noqa: E402
from repro.core import mctm as RM  # noqa: E402
from repro.core import mctm_fit as RF  # noqa: E402
from repro.core import scoring as RS  # noqa: E402
from repro.core.bernstein import DataScaler  # noqa: E402
from repro.data.dgp import generate  # noqa: E402
from repro_torch.core import bernstein as TB  # noqa: E402
from repro_torch.core import coreset as TC  # noqa: E402
from repro_torch.core import mctm as TM  # noqa: E402
from repro_torch.core import mctm_fit as TF  # noqa: E402

N, K, CHUNK, STEPS, ALPHA = 3001, 200, 1000, 30, 0.8


def _reference(cfg, scaler, Y, sk, inits):
    cs = RC.build_coreset(cfg, scaler, Y, K, key=jax.random.PRNGKey(0), alpha=ALPHA,
                          sketch_size=sk, chunk_size=CHUNK)
    w = np.asarray(cs.weights, np.float32)
    full = RF.fit_mctm_streaming(cfg, scaler, Y, init=inits[0], steps=STEPS, chunk_size=CHUNK)
    fit = RF.fit_mctm_streaming(cfg, scaler, Y[cs.indices], weights=w, init=inits[1],
                                steps=STEPS, chunk_size=CHUNK)
    a = RF.streamed_nll(cfg, scaler, fit.params, Y, chunk=CHUNK, eta=1e-9)
    b = RF.streamed_nll(cfg, scaler, full.params, Y, chunk=CHUNK, eta=1e-9)
    eps = RF.coreset_epsilon(cfg, scaler, Y, Y[cs.indices], w, [fit.params, full.params],
                             chunk=CHUNK, eta=1e-9, full_nlls=[a, b])
    return cs, eps, RF.likelihood_ratio(a, b)


def _port(cfg, scaler, Y, sk, inits, plans):
    cs = TC.build_coreset(cfg, scaler, Y, K, alpha=ALPHA, sketch_size=sk, chunk_size=CHUNK,
                          device="cpu", **plans)
    w = np.asarray(cs.weights, np.float32)
    full = TF.fit_mctm_streaming(cfg, scaler, Y, init=inits[0], steps=STEPS,
                                 chunk_size=CHUNK, device="cpu")
    fit = TF.fit_mctm_streaming(cfg, scaler, Y[cs.indices], weights=w, init=inits[1],
                                steps=STEPS, chunk_size=CHUNK, device="cpu")
    a = TF.streamed_nll(cfg, scaler, fit.params, Y, chunk=CHUNK, eta=1e-9, device="cpu")
    b = TF.streamed_nll(cfg, scaler, full.params, Y, chunk=CHUNK, eta=1e-9, device="cpu")
    eps = TF.coreset_epsilon(cfg, scaler, Y, Y[cs.indices], w, [fit.params, full.params],
                             chunk=CHUNK, eta=1e-9, full_nlls=[a, b], device="cpu")
    return cs, eps, TF.likelihood_ratio(a, b)


@pytest.mark.parametrize("sketch", [0, 784])
def test_slice_matches_reference(sketch):
    Y = generate("normal_mixture", N, seed=0).astype(np.float32)
    scaler = DataScaler.fit(Y)
    cfg = RM.MCTMConfig(J=2, degree=6)
    inits = [RM.init_params(k, cfg) for k in jax.random.split(jax.random.PRNGKey(1))]
    rcs, reps, rratio = _reference(cfg, scaler, Y, sketch, inits)

    # the reference's plans, derived exactly as its build_coreset derives them
    k_score, k_hull, _ = jax.random.split(jax.random.PRNGKey(0), 3)
    k_sample = int(np.floor(ALPHA * K))
    plans = {
        "hull_normals": np.asarray(jax.random.normal(k_hull, (4 * (K - k_sample), 7),
                                                     jnp.float32)),
        "draw": rcs.indices[:k_sample],
    }
    if sketch:
        plans["plan"] = tuple(None if p is None else np.asarray(p)
                              for p in RS.OnePassSketched(sketch).begin(N, 14, k_score))
    tinits = [TM.params_from_numpy(np.asarray(p.theta_raw), np.asarray(p.lam), device="cpu")
              for p in inits]
    tcs, teps, tratio = _port(TM.MCTMConfig(J=2, degree=6),
                              TB.DataScaler(low=scaler.low, high=scaler.high), Y, sketch,
                              tinits, plans)
    assert tcs.size == rcs.size == K
    assert abs(teps - reps) <= 1e-4
    assert abs(tratio - rratio) <= 1e-4
