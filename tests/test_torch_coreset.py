"""Coreset assembly of the port against the JAX package: given the same
ScoringResult and the same sample draw, identical indices (sampled and hull
union, exact-k top-up included) and weights to rtol 1e-5 (the same f32/f64
numpy arithmetic on both sides)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import coreset as RC  # noqa: E402
from repro.core import mctm as RM  # noqa: E402
from repro.core.bernstein import DataScaler  # noqa: E402
from repro.core.scoring import ScoringEngine  # noqa: E402
from repro.data.dgp import generate  # noqa: E402
from repro_torch.core import bernstein as TB  # noqa: E402
from repro_torch.core import coreset as TC  # noqa: E402
from repro_torch.core import mctm as TM  # noqa: E402

N = 1501


@pytest.fixture(scope="module")
def scored():
    Y = generate("bimodal_clusters", N, seed=2).astype(np.float32)
    scaler = DataScaler.fit(Y)
    cfg = RM.MCTMConfig(J=2, degree=6)
    res = ScoringEngine(cfg, scaler, chunk_size=500).score(
        jnp.asarray(Y), hull_k=40, hull_key=jax.random.PRNGKey(5))
    return Y, scaler, res


@pytest.mark.parametrize("method,k,alpha", [
    ("l2-hull", 200, 0.8), ("l2-hull", 50, 0.2), ("l2-only", 120, 0.8), ("root-l2", 90, 0.8),
])
def test_coreset_from_scoring_matches_reference(scored, method, k, alpha):
    _, _, res = scored
    key = jax.random.PRNGKey(k)
    ref = RC.coreset_from_scoring(res, N, k, method, alpha, key, 0.0)
    k_sample = int(np.floor(alpha * k)) if method == "l2-hull" else k
    probs = res.scores / res.scores.sum()
    draw = np.asarray(jax.random.choice(key, N, shape=(k_sample,), replace=True,
                                        p=jnp.asarray(probs)))
    got = TC.coreset_from_scoring(res, N, k, method, alpha, 0.0, draw=draw)
    np.testing.assert_array_equal(got.indices, ref.indices)
    np.testing.assert_allclose(got.weights, ref.weights, rtol=1e-5)
    assert got.size == k


def test_exact_hull_points_tops_up_like_reference(scored):
    _, _, res = scored
    k_hull = int(np.unique(res.hull_rows // 2).size) + 25  # more than the net found
    np.testing.assert_array_equal(
        TC.exact_hull_points(res, res.scores, k_hull),
        RC.exact_hull_points(res, res.scores, k_hull),
    )


@pytest.mark.parametrize("method", ["l2-hull", "uniform"])
def test_build_coreset_matches_reference(scored, method):
    """The whole build with the reference's plans: its hull normals and its
    draw (the sampled prefix of its own indices)."""
    Y, scaler, _ = scored
    cfg, k = RM.MCTMConfig(J=2, degree=6), 150
    key = jax.random.PRNGKey(9)
    ref = RC.build_coreset(cfg, scaler, Y, k, method, key=key, chunk_size=400)
    tscaler = TB.DataScaler(low=scaler.low, high=scaler.high)
    kw = {}
    if method == "l2-hull":
        _, k_hull, _ = jax.random.split(key, 3)
        kw["hull_normals"] = np.asarray(jax.random.normal(k_hull, (4 * 30, 7), jnp.float32))
    k_sample = 120 if method == "l2-hull" else k
    got = TC.build_coreset(TM.MCTMConfig(J=2, degree=6), tscaler, Y, k, method,
                           chunk_size=400, draw=ref.indices[:k_sample], device="cpu", **kw)
    np.testing.assert_array_equal(got.indices[:k_sample], ref.indices[:k_sample])
    # the hull tail: the port's own extremes on its own featurize (see
    # test_torch_scoring for why a few tied rows may resolve differently)
    common = np.intersect1d(got.indices[k_sample:], ref.indices[k_sample:]).size
    assert common >= 0.9 * (k - k_sample)
    # weights follow the scores (rtol 5e-3 there, see test_torch_scoring)
    np.testing.assert_allclose(got.weights, ref.weights, rtol=5e-3)
    assert got.size == ref.size == k


def test_random_draws_come_from_the_generator(scored):
    Y, scaler, _ = scored
    tscaler = TB.DataScaler(low=scaler.low, high=scaler.high)
    cfg = TM.MCTMConfig(J=2, degree=6)
    a = TC.build_coreset(cfg, tscaler, Y, 100, generator=torch.Generator().manual_seed(1),
                         sketch_size=64, device="cpu")
    b = TC.build_coreset(cfg, tscaler, Y, 100, generator=torch.Generator().manual_seed(1),
                         sketch_size=64, device="cpu")
    np.testing.assert_array_equal(a.indices, b.indices)
    assert a.size == 100 and np.all(a.weights > 0)
    with pytest.raises(ValueError):
        TC.build_coreset(cfg, tscaler, Y, 100, device="cpu")  # no generator, no plans


@pytest.fixture(scope="module")
def full_fit(scored):
    Y, scaler, _ = scored
    return RM.fit_mctm(RM.MCTMConfig(J=2, degree=6), scaler, jnp.asarray(Y), steps=150,
                       key=jax.random.PRNGKey(1))


@pytest.mark.parametrize("method", ["uniform", "l2-only", "l2-hull"])
def test_evaluate_coreset_matches_reference(scored, full_fit, method):
    """evaluate_coreset on the reference's plans: its build draw (the
    sampled prefix of its own coreset) and hull normals, and its fit's
    start from the fit key; the full fit's parameters carried over. The
    coresets share their sampled points; the hull tail and the weights
    follow each side's own scores (rtol 5e-3, see test_torch_scoring), so
    the refits agree to 2e-2 in param ℓ2 and λ error and 1e-3 in the
    likelihood ratio; 5e-2 in λ error for ``l2-hull``, whose hull tail
    shares ≥ 90% of its points (2.4% measured)."""
    Y, scaler, _ = scored
    cfg, k, steps = RM.MCTMConfig(J=2, degree=6), 150, 150
    key = jax.random.PRNGKey(7)
    ref = RC.evaluate_coreset(cfg, scaler, Y, full_fit, k, method, key, steps=steps)
    k_build, k_fit = jax.random.split(key)
    ref_cs = RC.build_coreset(cfg, scaler, Y, k, method, key=k_build)
    k_sample = 120 if method == "l2-hull" else k
    plans = {"draw": ref_cs.indices[:k_sample]}
    if method == "l2-hull":
        plans["hull_normals"] = np.asarray(
            jax.random.normal(jax.random.split(k_build, 3)[1], (4 * 30, 7), jnp.float32))
    normals = np.asarray(jax.random.normal(jax.random.split(k_fit)[0], (2, 7), jnp.float32))
    tcfg = TM.MCTMConfig(J=2, degree=6)
    tfull = TM.FitResult(
        params=TM.params_from_numpy(np.asarray(full_fit.params.theta_raw),
                                    np.asarray(full_fit.params.lam), device="cpu"),
        losses=np.asarray(full_fit.losses), final_nll=full_fit.final_nll)
    got = TC.evaluate_coreset(
        tcfg, TB.DataScaler(low=scaler.low, high=scaler.high), Y, tfull, k, method,
        build_plans=plans, init=TM.init_params(tcfg, normals=normals, device="cpu"),
        steps=steps, device="cpu")
    assert isinstance(got, TC.CoresetEvaluation)
    assert got.method == ref.method and got.k == ref.k == k
    assert got.param_l2 == pytest.approx(ref.param_l2, rel=2e-2)
    rel = 5e-2 if method == "l2-hull" else 2e-2
    assert got.lambda_err == pytest.approx(ref.lambda_err, rel=rel, abs=1e-4)
    assert got.likelihood_ratio == pytest.approx(ref.likelihood_ratio, abs=1e-3)
    assert got.fit_seconds > 0 and got.sample_seconds > 0


def test_sensitivity_sample_matches_reference(scored):
    from repro.core import sensitivity as RSe
    from repro_torch.core import sensitivity as TSe

    _, _, res = scored
    base = np.random.default_rng(0).uniform(0.5, 2.0, N)
    for bw in (None, base):
        key = jax.random.PRNGKey(3)
        ref = RSe.sensitivity_sample(key, res.scores, 200, bw)
        got = TSe.sensitivity_sample(res.scores, 200, bw, draw=ref.indices)
        np.testing.assert_array_equal(got.indices, ref.indices)
        np.testing.assert_allclose(got.weights, ref.weights, rtol=1e-12)
        np.testing.assert_allclose(got.probs, ref.probs, rtol=1e-12)
    a = TSe.sensitivity_sample(res.scores, 50, generator=torch.Generator().manual_seed(0))
    b = TSe.sensitivity_sample(res.scores, 50, generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(a.indices, b.indices)
    assert a.indices.shape == (50,) and np.all(a.weights > 0)
    with pytest.raises(ValueError):
        TSe.sensitivity_sample(res.scores, 50)  # no draw, no generator
    for args in ((12.5, 30, 0.1), (0.5, 5, 0.2, 0.05), (1e4, 100, 0.01)):
        assert TSe.sample_size_bound(*args) == RSe.sample_size_bound(*args)
