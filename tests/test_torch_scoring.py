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


def _lookup_featurizers(X, P, r=2):
    """Both engines read row i's (X, P) by its index in column 0 of Y (r P
    rows a point)."""

    def ref(Yc):
        idx = np.asarray(Yc[:, 0]).astype(np.int64)
        rows = (r * idx[:, None] + np.arange(r)).reshape(-1)
        return jnp.asarray(X[idx]), jnp.asarray(P[rows])

    Xt, Pt = torch.tensor(X), torch.tensor(P)

    def port(Yc):
        idx = Yc[:, 0].long()
        rows = (r * idx[:, None] + torch.arange(r)).reshape(-1)
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


def test_waiting_features_raise(data, tmp_path):
    """Bad options raise; the checkpointed sweep (``sweep_ckpt=``, once
    waiting) is ported and gives the plain sweep's bits."""
    Y, _, tscaler, _, _ = data
    eng = TS.ScoringEngine(TM.MCTMConfig(J=2, degree=6), tscaler, chunk_size=600,
                           device="cpu")
    np.testing.assert_array_equal(eng.score(Y, sweep_ckpt=str(tmp_path)).scores,
                                  eng.score(Y).scores)
    with pytest.raises(ValueError):
        eng.score(Y, strategy="three-pass")
    with pytest.raises(ValueError):
        eng.score(Y, sketch_size=8)  # a sketch needs a generator or a plan


@pytest.mark.parametrize("with_moments", [True, False])
def test_pass1_update_accumulates_like_the_reference(data, with_moments):
    """pass1_update folds the chunk's Gram into the running G through the
    gram wrapper's accumulator; over three chunks it matches the JAX
    package's pass1_update (Gram 1e-5 of max|G|, moments rtol 1e-5 / atol
    1e-4, as above) and equals G + gram_matrix(X, sw) bit for bit."""
    _, _, _, X, P = data
    sw = np.sqrt(np.random.default_rng(2).uniform(0.2, 3.0, N)).astype(np.float32)
    t = torch.tensor  # a copy: the fixture's arrays are read-only
    ref = (jnp.zeros((14, 14), jnp.float32), jnp.zeros(7, jnp.float32),
           jnp.zeros((7, 7), jnp.float32))
    got = (torch.zeros(14, 14), torch.zeros(7), torch.zeros(7, 7))
    for lo, hi in ((0, 700), (700, 1400), (1400, N)):
        Pc = P[2 * lo:2 * hi] if with_moments else None
        ref = RS.pass1_update(*ref, jnp.asarray(X[lo:hi]),
                              None if Pc is None else jnp.asarray(Pc), jnp.asarray(sw[lo:hi]))
        prev = got[0]
        got = TS.pass1_update(*got, t(X[lo:hi]), None if Pc is None else t(Pc), t(sw[lo:hi]))
        assert torch.equal(got[0], prev + TS.gram_matrix(t(X[lo:hi]), t(sw[lo:hi])))
    rg = np.asarray(ref[0])
    np.testing.assert_allclose(got[0].numpy(), rg, rtol=0, atol=1e-5 * np.abs(rg).max())
    if with_moments:
        for g, r in zip(got[1:], ref[1:]):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-4)


# J = 10 (D = 70), the paper's Table 2 configuration, on the ported covertype
# generator; the one-pass strategy with its default sketch 4·D² = 19,600
N10, J10, HULL_K10 = 3001, 10, 30
SK10 = 4 * (7 * J10) ** 2


@pytest.fixture(scope="module")
def covertype10():
    from repro_torch.data import generate_covertype

    Y = generate_covertype(N10, seed=0).astype(np.float32)
    scaler = DataScaler.fit(Y)
    cfg = RM.MCTMConfig(J=J10, degree=6)
    A, Ap = RM.basis_features(cfg, scaler, jnp.asarray(Y))
    X, P = np.asarray(A).reshape(N10, 7 * J10), np.asarray(Ap).reshape(J10 * N10, 7)
    return Y, scaler, TB.DataScaler(low=scaler.low, high=scaler.high), X, P


@pytest.mark.parametrize("name", ["two-pass", "one-pass"])
@pytest.mark.parametrize("chunk", [0, 1000])
def test_engine_matches_reference_at_j10(covertype10, name, chunk):
    """TwoPassExact and OnePassSketched(4·D²) at J = 10 against the JAX
    package's engine, ridge-lss scores to rtol 2e-5: on identical features
    with the same hull rows, and on each side's own featurize with ≥ 90% of
    the hull points in common (this file's tolerances, see the module doc)."""
    Y, scaler, tscaler, X, P = covertype10
    if name == "two-pass":
        rstrat, tstrat = RS.TwoPassExact(), TS.TwoPassExact()
    else:
        rstrat, tstrat = RS.OnePassSketched(SK10), TS.OnePassSketched(SK10)
    key, hull_key = jax.random.split(jax.random.PRNGKey(5))
    plan = None
    if rstrat.needs_key:
        plan = tuple(None if p is None else np.asarray(p)
                     for p in rstrat.begin(N10, 7 * J10, key))
    normals = np.asarray(jax.random.normal(hull_key, (4 * HULL_K10, 7), jnp.float32))
    rfeat, tfeat = _lookup_featurizers(X, P, r=J10)
    Yidx = np.stack([np.arange(N10), np.zeros(N10)], axis=1).astype(np.float32)
    kw, rkw = {"hull_normals": normals}, {}
    if not rstrat.one_pass:
        s1, s2 = P.sum(0), P.T.astype(np.float64) @ P
        rkw["hull_dirs"] = RS.directions_from_moments(hull_key, s1, s2, J10 * N10, HULL_K10)
        kw = {"hull_dirs": rkw["hull_dirs"]}
    ref = RS.ScoringEngine(featurize=rfeat, rows_per_point=J10, chunk_size=chunk).score(
        jnp.asarray(Yidx), method="ridge-lss", key=key, hull_k=HULL_K10, hull_key=hull_key,
        strategy=rstrat, **rkw)
    got = TS.ScoringEngine(featurize=tfeat, rows_per_point=J10, chunk_size=chunk,
                           device="cpu").score(
        Yidx, method="ridge-lss", plan=plan, hull_k=HULL_K10, strategy=tstrat, **kw)
    np.testing.assert_allclose(got.scores, ref.scores, rtol=2e-5)
    np.testing.assert_array_equal(got.hull_rows, ref.hull_rows)

    ref = RS.ScoringEngine(cfg=RM.MCTMConfig(J=J10, degree=6), scaler=scaler,
                           chunk_size=chunk).score(
        jnp.asarray(Y), method="ridge-lss", key=key, hull_k=HULL_K10, hull_key=hull_key,
        strategy=rstrat)
    got = TS.ScoringEngine(TM.MCTMConfig(J=J10, degree=6), tscaler, chunk_size=chunk,
                           device="cpu").score(
        Y, method="ridge-lss", plan=plan, hull_k=HULL_K10, hull_normals=normals,
        strategy=tstrat)
    assert got.scores.shape == (N10,) and np.all(np.isfinite(got.scores))
    np.testing.assert_allclose(got.scores, ref.scores, rtol=2e-5)
    common = np.intersect1d(got.hull_points, ref.hull_points).size
    assert common >= 0.9 * ref.hull_points.size


def _strategies64(name, q):
    if name == "two-pass":
        return RS.TwoPassExact("float64"), TS.TwoPassExact("float64")
    if name == "two-pass-sketched":
        return RS.TwoPassSketched(SK, "float64"), TS.TwoPassSketched(SK, "float64")
    return (RS.OnePassSketched(SK, "float64", proj_size=q),
            TS.OnePassSketched(SK, "float64", proj_size=q))


@pytest.mark.parametrize("name,q", STRATEGIES)
@pytest.mark.parametrize("chunk", [0, 500])
def test_float64_gram_matches_reference(data, name, q, chunk):
    """``gram_dtype="float64"`` for every strategy, the sketched ones under
    x64 as the reference requires, on identical features: the float64 Gram
    (or SX) to 1e-12 of its largest entry, and l2 scores (the ill-conditioned
    pseudo-inverse, which a float64 Gram no longer blurs) to rtol 2e-5 —
    the float32 leverage of the same (V, w⁺) on both sides; the hull rows
    exactly."""
    _, _, _, X, P = data
    rfeat, tfeat = _lookup_featurizers(X, P)
    Yidx = np.stack([np.arange(N), np.zeros(N)], axis=1).astype(np.float32)
    rstrat, tstrat = _strategies64(name, q)
    key, hull_key = jax.random.split(jax.random.PRNGKey(12))
    kw, rkw = {}, {}
    if rstrat.one_pass:
        kw["hull_normals"] = np.asarray(jax.random.normal(hull_key, (4 * HULL_K, 7)))
    else:
        s1, s2 = P.sum(0), P.T.astype(np.float64) @ P
        rkw["hull_dirs"] = kw["hull_dirs"] = RS.directions_from_moments(
            hull_key, s1, s2, 2 * N, HULL_K)
    with jax.enable_x64(name != "two-pass"):
        plan = _plan(rstrat, key)
        ref = RS.ScoringEngine(featurize=rfeat, rows_per_point=2, chunk_size=chunk).score(
            jnp.asarray(Yidx), method="l2-hull", key=key, hull_k=HULL_K, hull_key=hull_key,
            strategy=rstrat, **rkw)
    got = TS.ScoringEngine(featurize=tfeat, rows_per_point=2, chunk_size=chunk,
                           device="cpu").score(
        Yidx, method="l2-hull", plan=plan, hull_k=HULL_K, strategy=tstrat, **kw)
    assert got.gram.dtype == np.float64
    np.testing.assert_allclose(got.gram, ref.gram, rtol=0,
                               atol=1e-12 * np.abs(ref.gram).max())
    np.testing.assert_allclose(got.scores, ref.scores, rtol=2e-5)
    np.testing.assert_array_equal(got.hull_rows, ref.hull_rows)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_countsketch_add_adds_in_row_order(dtype):
    """The CountSketch in the carry's dtype against a sequential row-by-row
    loop from the carry, to the bit, with buckets that take none, one and
    many rows."""
    gen = torch.Generator().manual_seed(0)
    SX = torch.randn(9, 5, generator=gen, dtype=torch.float64).to(dtype)
    V = torch.randn(300, 5, generator=gen) * torch.logspace(-6, 3, 300)[:, None]
    rows = torch.randint(0, 7, (300,), generator=gen)
    rows[:40] = 3
    want = SX.clone()
    for i in range(300):
        want[rows[i]] += V[i].to(dtype)
    got = TS.countsketch_add(SX, V, rows)
    assert torch.equal(got, want) and got.dtype == dtype
    assert torch.equal(TS.countsketch_add(SX, V[:0], rows[:0]), SX)


WIDE_D = 24  # P = X wider than the sweep kernel's d ≤ 16: the wide-P route


@pytest.mark.parametrize("name", ["two-pass-sketched", "one-pass"])
@pytest.mark.parametrize("chunk", [0, 500])
def test_wide_feature_rows_match_reference(name, chunk, monkeypatch):
    """P = X at D = 24 (``rows_per_point=1``, as ``CoresetSelector`` scores
    feature rows): the sketched strategies take the wide-P route (the
    chunk's extremes beside the sweep, the moments (Σp, Σppᵀ) on the gram
    wrapper, ``_gram_moments``). Against the reference's ``ScoringEngine``
    on its own plans: scores rtol 2e-5 (well-conditioned Gaussian rows),
    hull rows exact, moments rtol 1e-5 / atol 1e-4 (another f32 order)."""
    X = np.random.default_rng(7).normal(size=(N, WIDE_D)).astype(np.float32)
    rfeat, tfeat = _lookup_featurizers(X, X, r=1)
    Yidx = np.stack([np.arange(N), np.zeros(N)], axis=1).astype(np.float32)
    if name == "one-pass":
        rstrat = RS.OnePassSketched(SK, track_moments=True)
        tstrat = TS.OnePassSketched(SK, track_moments=True)
    else:
        rstrat, tstrat = RS.TwoPassSketched(SK), TS.TwoPassSketched(SK)
    key, hull_key = jax.random.split(jax.random.PRNGKey(13))
    kw = {}
    if rstrat.one_pass:
        kw["hull_normals"] = np.asarray(jax.random.normal(hull_key, (4 * HULL_K, WIDE_D)))
        rkw = {}
    else:
        s1, s2 = X.sum(0), X.T.astype(np.float64) @ X
        kw["hull_dirs"] = rkw = RS.directions_from_moments(hull_key, s1, s2, N, HULL_K)
        rkw = {"hull_dirs": rkw}
    ref = RS.ScoringEngine(featurize=rfeat, rows_per_point=1, chunk_size=chunk).score(
        jnp.asarray(Yidx), method="l2-hull", key=key, hull_k=HULL_K, hull_key=hull_key,
        strategy=rstrat, **rkw)
    moment_calls = []
    real = TS._gram_moments
    monkeypatch.setattr(TS, "_gram_moments",
                        lambda *a: moment_calls.append(a[2].shape) or real(*a))
    got = TS.ScoringEngine(featurize=tfeat, rows_per_point=1, chunk_size=chunk,
                           device="cpu").score(
        Yidx, method="l2-hull", plan=_plan_at(rstrat, key, WIDE_D), hull_k=HULL_K,
        strategy=tstrat, **kw)
    assert len(moment_calls) == got.n_chunks == ref.n_chunks
    np.testing.assert_allclose(got.scores, ref.scores, rtol=2e-5)
    np.testing.assert_array_equal(got.hull_rows, ref.hull_rows)
    if rstrat.one_pass:
        for g, r in zip(got.moments[:2], ref.moments[:2]):
            np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-4)


def test_gram_moments_are_the_moments():
    """``_gram_moments`` adds Σp and Σppᵀ to the carry (float64 of the same
    rows: rtol 1e-6, f32 rounding of sums up to ~3,000, atol 1e-4)."""
    rng = np.random.default_rng(3)
    P = torch.tensor(rng.normal(size=(3000, 20)).astype(np.float32))
    s1 = torch.tensor(rng.normal(size=20).astype(np.float32))
    s2 = torch.tensor(rng.normal(size=(20, 20)).astype(np.float32))
    g1, g2 = TS._gram_moments(s1, s2, P)
    P64 = P.double()
    torch.testing.assert_close(g1.double(), s1.double() + P64.sum(0), rtol=1e-6, atol=1e-4)
    torch.testing.assert_close(g2.double(), s2.double() + P64.T @ P64, rtol=1e-6, atol=1e-4)


def _plan_at(rstrat, key, D):
    return tuple(None if p is None else np.asarray(p) for p in rstrat.begin(N, D, key))
