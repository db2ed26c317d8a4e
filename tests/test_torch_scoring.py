"""ScoringEngine of the port against the JAX package's, for every strategy,
dense (chunk_size=0) and chunked with a ragged tail, with the reference's
own random plans handed to the port: the CountSketch rows/signs/Ω from the
reference strategy's ``begin`` and the hull net's normal draws from its hull
key (or the reference's net itself via ``hull_dirs``).

Two layers, because two things differ between any two f32 evaluations:

* The engine with identical inputs: both engines read the same (X, P) bits
  through a lookup ``featurize`` and score with ``ridge-lss``, whose
  G + λI is well conditioned. Scores agree to rtol 2e-5 (1e-5 but for the
  Ω-projected sketch, whose Gram (SXΩ)ᵀ(SXΩ) is summed in another order and
  reaches 1.06e-5) and the hull rows exactly (first occurrence on ties).
* The whole scoring path on DGP data with each side's own Bernstein
  featurize. The pseudo-inverse of the degree-6 Gram is ill conditioned
  (λ₂/λ_max ≈ 1.4e-5 on this data, the null mode of the partition of unity
  excluded), so f32 sums taken in another order move l2 leverage by up to
  ~3e-3 relative — the reference itself moves 7e-4 between chunk_size 0
  and 700. Scores are held to rtol 5e-3 there, and the hull points to 90%
  overlap: the JAX package's ``jnp.power`` is not correctly rounded (it
  differs from every torch evaluation in the last bit of 0.1–2% of values),
  and the derivative rows lie on curves whose neighbours tie within f32
  resolution.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import mctm as RM  # noqa: E402
from repro.core import scoring as RS  # noqa: E402
from repro.core.bernstein import DataScaler  # noqa: E402
from repro.data.dgp import generate  # noqa: E402
from repro_torch.core import bernstein as TB  # noqa: E402
from repro_torch.core import mctm as TM  # noqa: E402
from repro_torch.core import scoring as TS  # noqa: E402

N, SK, HULL_K = 2001, 196, 30
STRATEGIES = [("two-pass", None), ("two-pass-sketched", None), ("one-pass", None),
              ("one-pass", 9)]


@pytest.fixture(scope="module")
def data():
    Y = generate("normal_mixture", N, seed=4).astype(np.float32)
    scaler = DataScaler.fit(Y)
    cfg = RM.MCTMConfig(J=2, degree=6)
    A, Ap = RM.basis_features(cfg, scaler, jnp.asarray(Y))
    X, P = np.asarray(A).reshape(N, 14), np.asarray(Ap).reshape(2 * N, 7)
    return Y, scaler, TB.DataScaler(low=scaler.low, high=scaler.high), X, P


def _strategies(name, q):
    if name == "two-pass":
        return RS.TwoPassExact(), TS.TwoPassExact()
    if name == "two-pass-sketched":
        return RS.TwoPassSketched(SK), TS.TwoPassSketched(SK)
    return RS.OnePassSketched(SK, proj_size=q), TS.OnePassSketched(SK, proj_size=q)


def _plan(rstrat, key):
    if not rstrat.needs_key:
        return None
    return tuple(None if p is None else np.asarray(p) for p in rstrat.begin(N, 14, key))


def _lookup_featurizers(X, P):
    """Both engines read row i's (X, P) by its index in column 0 of Y."""

    def ref(Yc):
        idx = np.asarray(Yc[:, 0]).astype(np.int64)
        rows = (2 * idx[:, None] + np.arange(2)).reshape(-1)
        return jnp.asarray(X[idx]), jnp.asarray(P[rows])

    Xt, Pt = torch.tensor(X), torch.tensor(P)

    def port(Yc):
        idx = Yc[:, 0].long()
        rows = (2 * idx[:, None] + torch.arange(2)).reshape(-1)
        return Xt[idx], Pt[rows]

    return ref, port


@pytest.mark.parametrize("name,q", STRATEGIES)
@pytest.mark.parametrize("chunk", [0, 500])
def test_engine_matches_reference_on_identical_features(data, name, q, chunk):
    _, _, _, X, P = data
    rfeat, tfeat = _lookup_featurizers(X, P)
    Yidx = np.stack([np.arange(N), np.zeros(N)], axis=1).astype(np.float32)
    rstrat, tstrat = _strategies(name, q)
    key, hull_key = jax.random.split(jax.random.PRNGKey(11))
    ref = RS.ScoringEngine(featurize=rfeat, rows_per_point=2, chunk_size=chunk).score(
        jnp.asarray(Yidx), method="ridge-lss", key=key, hull_k=HULL_K, hull_key=hull_key,
        strategy=rstrat,
    )
    # two-pass nets come from the streamed moments: hand over the
    # reference's net so both extremes see the same directions; the one-pass
    # net is built by the port from the reference's normal draws
    kw = {}
    if rstrat.one_pass:
        kw["hull_normals"] = np.asarray(jax.random.normal(hull_key, (4 * HULL_K, 7)))
    else:
        s1, s2 = P.sum(0), P.T.astype(np.float64) @ P
        kw["hull_dirs"] = RS.directions_from_moments(hull_key, s1, s2, 2 * N, HULL_K)
        ref = RS.ScoringEngine(featurize=rfeat, rows_per_point=2, chunk_size=chunk).score(
            jnp.asarray(Yidx), method="ridge-lss", key=key, hull_k=HULL_K,
            hull_key=hull_key, hull_dirs=kw["hull_dirs"], strategy=rstrat,
        )
    got = TS.ScoringEngine(featurize=tfeat, rows_per_point=2, chunk_size=chunk,
                           device="cpu").score(
        Yidx, method="ridge-lss", plan=_plan(rstrat, key), hull_k=HULL_K, strategy=tstrat,
        **kw,
    )
    assert got.n_chunks == ref.n_chunks
    np.testing.assert_allclose(got.scores, ref.scores, rtol=2e-5)
    np.testing.assert_array_equal(got.hull_rows, ref.hull_rows)
    np.testing.assert_array_equal(got.hull_points, ref.hull_points)
    np.testing.assert_allclose(got.gram, ref.gram, rtol=0, atol=1e-5 * np.abs(ref.gram).max())


@pytest.mark.parametrize("name,q", STRATEGIES)
@pytest.mark.parametrize("chunk", [0, 500])
@pytest.mark.parametrize("method", ["l2-hull", "root-l2"])
def test_scoring_path_matches_reference(data, name, q, chunk, method):
    Y, scaler, tscaler, _, _ = data
    cfg = RM.MCTMConfig(J=2, degree=6)
    rstrat, tstrat = _strategies(name, q)
    key, hull_key = jax.random.split(jax.random.PRNGKey(11))
    ref = RS.ScoringEngine(cfg, scaler, chunk_size=chunk).score(
        jnp.asarray(Y), method=method, key=key, hull_k=HULL_K, hull_key=hull_key,
        strategy=rstrat,
    )
    normals = np.asarray(jax.random.normal(hull_key, (4 * HULL_K, 7), jnp.float32))
    got = TS.ScoringEngine(TM.MCTMConfig(J=2, degree=6), tscaler, chunk_size=chunk,
                           device="cpu").score(
        Y, method=method, plan=_plan(rstrat, key), hull_k=HULL_K, hull_normals=normals,
        strategy=tstrat,
    )
    assert got.n_chunks == ref.n_chunks and got.rows_per_point == 2
    assert got.scores.shape == (N,) and np.all(np.isfinite(got.scores))
    np.testing.assert_allclose(got.scores, ref.scores, rtol=5e-3)
    common = np.intersect1d(got.hull_points, ref.hull_points).size
    assert common >= 0.9 * ref.hull_points.size


def test_track_moments_and_hull_dirs_override(data):
    Y, scaler, tscaler, _, _ = data
    cfg = RM.MCTMConfig(J=2, degree=6)
    key, hull_key = jax.random.split(jax.random.PRNGKey(2))
    dirs = RS.upfront_directions(hull_key, 7, 10)
    rstrat = RS.OnePassSketched(SK, track_moments=True)
    ref = RS.ScoringEngine(cfg, scaler, chunk_size=700).score(
        jnp.asarray(Y), key=key, hull_k=10, hull_key=hull_key, hull_dirs=dirs,
        strategy=rstrat)
    got = TS.ScoringEngine(TM.MCTMConfig(J=2, degree=6), tscaler, chunk_size=700,
                           device="cpu").score(
        Y, plan=_plan(rstrat, key), hull_k=10, hull_dirs=dirs,
        strategy=TS.OnePassSketched(SK, track_moments=True))
    np.testing.assert_allclose(got.scores, ref.scores, rtol=5e-3)
    assert got.moments[2] == ref.moments[2] == 2 * N
    for g, r in zip(got.moments[:2], ref.moments[:2]):
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-4)


def test_weighted_ridge_scores_match_reference(data):
    Y, scaler, tscaler, _, _ = data
    w = np.random.default_rng(0).uniform(0.2, 3.0, N).astype(np.float32)
    cfg = RM.MCTMConfig(J=2, degree=6)
    ref = RS.score_chunks(cfg, scaler, jnp.asarray(Y), chunk_size=600, method="ridge-lss",
                          weights=jnp.asarray(w))
    got = TS.score_chunks(TM.MCTMConfig(J=2, degree=6), tscaler, Y, chunk_size=600,
                          method="ridge-lss", weights=w, device="cpu")
    np.testing.assert_allclose(got.scores, ref.scores, rtol=1e-5)
    assert got.hull_rows is None and ref.hull_rows is None


def test_waiting_features_raise(data):
    Y, _, tscaler, _, _ = data
    eng = TS.ScoringEngine(TM.MCTMConfig(J=2, degree=6), tscaler, device="cpu")
    with pytest.raises(NotImplementedError):
        eng.score(Y, sweep_ckpt="/nonexistent")
    with pytest.raises(NotImplementedError):
        eng.score(Y, gram_dtype="float64")
    with pytest.raises(ValueError):
        eng.score(Y, strategy="three-pass")
    with pytest.raises(ValueError):
        eng.score(Y, sketch_size=8)  # a sketch needs a generator or a plan
