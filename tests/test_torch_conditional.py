"""Conditional MCTM of the port against the JAX package's
(``repro.core.conditional``) on the reference test's linear-shift data
(tests/test_conditional.py: X ~ N(0, I₂), β = [[1.5, −0.5], [0.3, 0.8]],
ε correlated at 0.6, numpy seed 0), with the reference's random plans handed
over. Tolerances: cnll_terms rtol 1e-6 (the same formulas in float32); the
fits from carried parameters atol 5e-4 on every leaf (the reference's own
tolerance in tests/test_conditional.py) and their final NLLs rtol 1e-5;
the scores atol 5e-4 on each side's own featurize (the same reference
tolerance; the l2 pseudo-inverse turns another float32 summation order into
~1e-4 here); the coreset's sampled ids exactly, its hull points ≥ 90% in
common and its weights rtol 5e-3, as tests/test_torch_coreset.py holds the
unconditional build."""
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import conditional as RCo  # noqa: E402
from repro.core import mctm as RM  # noqa: E402
from repro.core import scoring as RS  # noqa: E402
from repro.core.bernstein import DataScaler  # noqa: E402
from repro_torch.core import bernstein as TB  # noqa: E402
from repro_torch.core import conditional as TCo  # noqa: E402
from repro_torch.core import mctm as TM  # noqa: E402


@pytest.fixture(scope="module")
def cond_data():
    rng = np.random.default_rng(0)
    n, F = 4000, 2
    X = rng.standard_normal((n, F))
    beta_true = np.array([[1.5, -0.5], [0.3, 0.8]])
    eps = rng.standard_normal((n, 2)) @ np.linalg.cholesky(np.array([[1, 0.6], [0.6, 1]])).T
    Y = X @ beta_true.T + eps
    scaler = DataScaler.fit(Y)
    return X, Y, beta_true, scaler, TB.DataScaler(low=scaler.low, high=scaler.high)


def _cfgs(degree=5, F=2):
    return (RCo.CMCTMConfig(J=2, n_features=F, degree=degree),
            TCo.CMCTMConfig(J=2, n_features=F, degree=degree))


def test_cnll_terms_match_reference(cond_data):
    X, Y, _, scaler, tscaler = cond_data
    cfg, tcfg = _cfgs()
    rng = np.random.default_rng(1)
    theta, lam, beta = rng.normal(0, 0.5, (2, 6)), rng.normal(0, 0.5, (1,)), rng.normal(size=(2, 2))
    params = RCo.CMCTMParams(*(jnp.asarray(a, jnp.float32) for a in (theta, lam, beta)))
    A, Ap = RM.basis_features(cfg.base, scaler, jnp.asarray(Y, jnp.float32))
    Xj = jnp.asarray(X, jnp.float32)
    ref = np.asarray(RCo.cnll_terms(cfg, params, A, Ap, Xj))
    w = rng.uniform(0.5, 2.0, Y.shape[0]).astype(np.float32)
    tp = TCo.cparams_from_numpy(theta, lam, beta, device="cpu")
    At, Apt, Xt = (torch.tensor(np.asarray(a)) for a in (A, Ap, Xj))
    with torch.no_grad():
        got = TCo.cnll_terms(tcfg, tp, At, Apt, Xt).numpy()
        total = float(TCo.cnll(tcfg, tp, At, Apt, Xt, torch.tensor(w)))
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    assert total == pytest.approx(float(RCo.cnll(cfg, params, A, Ap, Xj, jnp.asarray(w))),
                                  rel=1e-6)
    for a, b in zip(TCo.cparams_to_numpy(tp), (theta, lam, beta)):
        np.testing.assert_array_equal(a, b.astype(np.float32))


@pytest.mark.parametrize("method,chunk,steps", [("adam", None, 120), ("adam", 700, 60),
                                                ("lbfgs", 1000, 40)])
def test_fit_cmctm_matches_reference(cond_data, method, chunk, steps):
    """The reference's start (``init_cparams`` of its key, β = 0) carried
    over; adam dense (features once) and chunked, and lbfgs, on 1,500
    weighted points."""
    X, Y, _, scaler, tscaler = cond_data
    cfg, tcfg = _cfgs()
    n = 1500
    w = np.random.default_rng(2).uniform(0.5, 2.0, n).astype(np.float32)
    key = jax.random.PRNGKey(4)
    ref = RCo.fit_cmctm(cfg, scaler, Y[:n], X[:n], weights=w, key=key, steps=steps,
                        method=method, chunk_size=chunk)
    normals = np.asarray(jax.random.normal(jax.random.split(key)[0], (2, 6), jnp.float32))
    init = TCo.init_cparams(tcfg, normals=normals, device="cpu")
    r0 = RCo.init_cparams(key, cfg)
    for a, b in zip(TCo.cparams_to_numpy(init), r0):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-6)
    got = TCo.fit_cmctm(tcfg, tscaler, Y[:n], X[:n], weights=w, init=init, steps=steps,
                        method=method, chunk_size=chunk, device="cpu")
    assert isinstance(got.params, TCo.CMCTMParams) and got.losses.shape == (steps,)
    for a, b in zip(TCo.cparams_to_numpy(got.params), ref.params):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=5e-4)
    assert got.final_nll == pytest.approx(ref.final_nll, rel=1e-5)


def test_fit_cmctm_recovers_the_shift(cond_data):
    """The reference test's recovery check on the port: the conditional fit
    beats the unconditional one by ≥ 0.2 nats a point, and β's first row
    points along the true one (correlation > 0.9)."""
    X, Y, beta_true, _, tscaler = cond_data
    _, tcfg = _cfgs()
    g = torch.Generator().manual_seed(0)
    fit = TCo.fit_cmctm(tcfg, tscaler, Y, X, steps=900, generator=g, device="cpu")
    uncond = TM.fit_mctm(tcfg.base, tscaler, Y, steps=900, generator=g, device="cpu")
    assert fit.final_nll < uncond.final_nll - 0.2 * Y.shape[0]
    b = fit.params.beta.numpy()
    assert abs(np.corrcoef(b[0], beta_true[0])[0, 1]) > 0.9


@pytest.mark.parametrize("chunk,sketch", [(None, 0), (257, 0), (1000, 96)])
def test_conditional_scores_match_reference(cond_data, chunk, sketch):
    X, Y, _, scaler, tscaler = cond_data
    cfg, tcfg = _cfgs()
    key = jax.random.PRNGKey(6) if sketch else None
    ref = RCo.conditional_coreset_scores(cfg, scaler, Y, X, chunk_size=chunk,
                                         sketch_size=sketch, key=key)
    plan = None
    if sketch:
        plan = tuple(np.asarray(a) for a in RS.sketch_plan(key, Y.shape[0], sketch))
    got = TCo.conditional_coreset_scores(tcfg, tscaler, Y, X, chunk_size=chunk,
                                         sketch_size=sketch, plan=plan, device="cpu")
    assert got.shape == (Y.shape[0],) and np.all(got > 0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=5e-4)


def _build_plans(key, n, k, alpha, d, sketch):
    """The reference's draw order for the conditional build: (draw, hull
    [, sketch]); the hull net's normal draws and the CountSketch plan."""
    k2 = k - int(np.floor(alpha * k))
    keys = jax.random.split(key, 3 if sketch else 2)
    plans = {"hull_normals": np.asarray(jax.random.normal(keys[1], (max(4 * k2, 8), d),
                                                          jnp.float32))}
    if sketch:
        plans["plan"] = tuple(np.asarray(a) for a in RS.sketch_plan(keys[2], n, sketch))
    return plans, int(np.floor(alpha * k))


@pytest.mark.parametrize("sketch", [0, 100])
def test_build_conditional_coreset_matches_reference(cond_data, sketch):
    X, Y, _, scaler, tscaler = cond_data
    cfg, tcfg = _cfgs()
    key, k, alpha = jax.random.PRNGKey(1), 200, 0.8
    ref_idx, ref_w = RCo.build_conditional_coreset(cfg, scaler, Y, X, k=k, key=key,
                                                   chunk_size=1500, sketch_size=sketch)
    plans, k1 = _build_plans(key, Y.shape[0], k, alpha, cfg.d, sketch)
    idx, w = TCo.build_conditional_coreset(tcfg, tscaler, Y, X, k, chunk_size=1500,
                                           sketch_size=sketch, draw=ref_idx[:k1],
                                           device="cpu", **plans)
    assert idx.shape == w.shape == (k,)
    np.testing.assert_array_equal(idx[:k1], ref_idx[:k1])
    assert np.intersect1d(idx[k1:], ref_idx[k1:]).size >= 0.9 * (k - k1)
    np.testing.assert_allclose(w, ref_w, rtol=5e-3)


def test_build_conditional_coreset_exact_k_low_diversity_hull():
    """The reference's adversarial hull (tests/test_conditional.py): nearly
    every point identical, so the hull rows dedup to a handful of points;
    the build still returns exactly k ids, the hull part topped up without
    duplicates, the same ids as the reference on its plans."""
    rng = np.random.default_rng(5)
    n, F = 400, 2
    Y = np.tile(rng.standard_normal((1, 2)), (n, 1))
    Y[:5] = rng.standard_normal((5, 2)) * 3.0
    X = rng.standard_normal((n, F))
    cfg, tcfg = _cfgs(F=F)
    scaler = DataScaler.fit(Y)
    key, k, alpha = jax.random.PRNGKey(2), 80, 0.2
    ref_idx, ref_w = RCo.build_conditional_coreset(cfg, scaler, Y, X, k=k, key=key, alpha=alpha)
    plans, k1 = _build_plans(key, n, k, alpha, cfg.d, 0)
    idx, w = TCo.build_conditional_coreset(
        tcfg, TB.DataScaler(low=scaler.low, high=scaler.high), Y, X, k, alpha=alpha,
        draw=ref_idx[:k1], device="cpu", **plans)
    assert idx.shape == w.shape == (k,) and (w > 0).all()
    assert len(set(idx[k1:].tolist())) == k - k1
    np.testing.assert_array_equal(idx, ref_idx)
    np.testing.assert_allclose(w, ref_w, rtol=5e-3)
    g = torch.Generator().manual_seed(3)
    a = TCo.build_conditional_coreset(tcfg, TB.DataScaler(low=scaler.low, high=scaler.high),
                                      Y, X, k, alpha=alpha, generator=g, device="cpu")
    assert a[0].shape == (k,) and len(set(a[0][k1:].tolist())) == k - k1


def test_unported_fit_options_raise(cond_data, tmp_path):
    """mesh= is ported (a world of 1 fits to the bits of no mesh; worlds
    of 2 and 4 are held to the reference in tests/test_torch_mesh_fit.py);
    minibatch is ported (a
    sampled fit runs its steps to a finite NLL; its parity with the
    reference is in tests/test_torch_minibatch.py); checkpoint= and resume=
    are ported: a fit that crashes at
    step 4 resumes from its step-3 checkpoint and ends on the straight
    fit's bits."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.ft import FailureSimulator, get_ft_config

    X, Y, _, _, tscaler = cond_data
    _, tcfg = _cfgs()
    from repro_torch.distributed import DataMesh

    init0 = TCo.init_cparams(tcfg, generator=torch.Generator().manual_seed(0), device="cpu")
    on_mesh = TCo.fit_cmctm(tcfg, tscaler, Y[:50], X[:50], steps=2, init=init0,
                            mesh=DataMesh(device="cpu"))
    plain = TCo.fit_cmctm(tcfg, tscaler, Y[:50], X[:50], steps=2, init=init0, device="cpu")
    np.testing.assert_array_equal(on_mesh.losses, plain.losses)
    assert on_mesh.final_nll == plain.final_nll
    mini = TCo.fit_cmctm(tcfg, tscaler, Y[:50], X[:50], steps=3, method="minibatch",
                         batch_size=16, device="cpu",
                         init=TCo.init_cparams(tcfg, generator=torch.Generator().manual_seed(0),
                                               device="cpu"))
    assert mini.losses.shape == (3,) and np.isfinite(mini.final_nll)
    init = TCo.init_cparams(tcfg, generator=torch.Generator().manual_seed(0), device="cpu")
    common = dict(init=init, steps=6, device="cpu")
    straight = TCo.fit_cmctm(tcfg, tscaler, Y[:50], X[:50], **common)
    ft = get_ft_config()
    ft.simulator = sim = FailureSimulator().inject("fit", 4)
    try:
        resumed = TCo.fit_cmctm(tcfg, tscaler, Y[:50], X[:50], device="cpu", init=init,
                                steps=6, checkpoint=CheckpointManager(str(tmp_path)),
                                ckpt_every=3)
    finally:
        ft.simulator = None
    assert [e["step"] for e in sim.log] == [4]
    for a, b in zip(straight.params, resumed.params):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        TCo.conditional_coreset_scores(tcfg, tscaler, Y[:50], X[:50, :1], device="cpu")
