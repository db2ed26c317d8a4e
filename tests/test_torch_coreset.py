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
