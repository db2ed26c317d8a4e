"""The port's ``core.distributed_coreset`` on gloo worlds of 2 and 4 CPU
ranks against the JAX package's on meshes of 2 and 4 fake CPU devices, on
the reference test's ragged input (n = 1,003, chunk 64: ragged shards and
ragged chunks, tests/test_distributed.py) with the reference's random plans
handed over (the hull nets' normal draws, the CountSketch plans, the sample
draw).

Each side runs once a module: the JAX side in one subprocess (4 fake
devices; the 2-rank mesh takes the first two), the port's in one spawned
world per size, every check of that size in it.

Tolerances (degree 5 unless stated, where the Gram's spectrum sits above the
f32 noise floor): two-pass scores 1e-6 of the reference and of the port's
single-host engine, hull rows[:20] and ``exact_hull_points`` equal;
weighted l2-only 5e-6 (the reference's own sharded-vs-single limit); one-pass
at sketch 256 2e-6, not the reference's 1e-6: its own sharded-vs-single gap
is 1.065e-6 on this input (its test of that limit is red), f32 sums of the
sketch in another order; ``OnePassSketched(256, proj_size=8)`` weighted
5e-6. Degree 6 only with ``gram_dtype="float64"`` (1e-6): in f32 another
summation order moves its ill-conditioned leverage by ~1e-4.
"""
import textwrap

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import bernstein as RB  # noqa: E402
from repro.core import mctm as RM  # noqa: E402
from repro.core import scoring as RS  # noqa: E402
from repro_torch.core import coreset as TC  # noqa: E402
from repro_torch.core import distributed_coreset as TD  # noqa: E402
from repro_torch.core import scoring as TS  # noqa: E402
from repro_torch.core.bernstein import DataScaler  # noqa: E402
from repro_torch.distributed import DataMesh  # noqa: E402
from torch_mesh_ranks import (  # noqa: E402
    CHUNK, HULL_K, N, SK, WORLDS, cfg, double, run_reference_and_worlds, score_all, select,
)

REFERENCE = textwrap.dedent("""
    import sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh
    from repro.core import mctm as M
    from repro.core.bernstein import DataScaler
    from repro.core import distributed_coreset as DC
    from repro.core.scoring import OnePassSketched
    from repro.core.coreset import exact_hull_points
    from repro.data.pipeline import CoresetSelector

    out = {}
    rng = np.random.default_rng(0)
    Y = rng.random((1003, 2)).astype(np.float32)
    w = (rng.random(1003) * 3.0 + 0.1).astype(np.float32)
    Y6 = rng.standard_normal((1003, 2)).astype(np.float32)
    X = rng.standard_normal((640, 12)).astype(np.float32)
    P = rng.standard_normal((640, 5)).astype(np.float32)
    ex = np.random.default_rng(0).standard_normal((1003, 6)).astype(np.float32)
    cfg = M.MCTMConfig(J=2, degree=5)
    scaler = DataScaler.fit(Y)
    hkey, skey = jax.random.PRNGKey(3), jax.random.PRNGKey(9)
    A, Ap = M.basis_features(cfg, scaler, jnp.asarray(Y))
    Xt, Pt = A.reshape(1003, 12), Ap.reshape(2006, 6)

    def look(Yc):
        idx = Yc[:, 0].astype(jnp.int32)
        rows = (2 * idx[:, None] + jnp.arange(2)).reshape(-1)
        return jnp.take(Xt, idx, axis=0), jnp.take(Pt, rows, axis=0)

    ids = jnp.arange(1003, dtype=jnp.float32)[:, None]
    for R in (2, 4):
        mesh = Mesh(np.array(jax.devices()[:R]), ("data",))
        leng = DC.DistributedScoringEngine(featurize=look, rows_per_point=2, mesh=mesh,
                                           chunk_size=64)
        for tag, kw in (("two", {}), ("one", {"sketch_size": 256, "key": skey})):
            r = leng.score(ids, method="l2-hull", hull_k=20, hull_key=hkey, **kw)
            out[f"R{R}_look_{tag}"], out[f"R{R}_look_{tag}_hull"] = r.scores, r.hull_rows
            out[f"R{R}_look_{tag}_exact"] = exact_hull_points(r, r.scores, 20)
        eng = DC.DistributedScoringEngine(cfg, scaler, mesh=mesh, chunk_size=64)
        r = eng.score(jnp.asarray(Y), method="l2-hull", hull_k=20, hull_key=hkey)
        out[f"R{R}_two"], out[f"R{R}_two_hull"] = r.scores, r.hull_rows
        out[f"R{R}_two_exact"] = exact_hull_points(r, r.scores, 20)
        out[f"R{R}_two_w"] = eng.score(jnp.asarray(Y), method="l2-only", weights=w).scores
        r = eng.score(jnp.asarray(Y), method="l2-hull", hull_k=20, hull_key=hkey,
                      sketch_size=256, key=skey)
        out[f"R{R}_one"], out[f"R{R}_one_hull"] = r.scores, r.hull_rows
        out[f"R{R}_one_exact"] = exact_hull_points(r, r.scores, 20)
        out[f"R{R}_one_q8_w"] = eng.score(jnp.asarray(Y), method="l2-only", weights=w, key=skey,
                                          strategy=OnePassSketched(256, proj_size=8)).scores
        cs = DC.distributed_build_coreset(cfg, scaler, Y, 100, "l2-hull", mesh=mesh,
                                          key=jax.random.PRNGKey(7), chunk_size=64)
        out[f"R{R}_cs_idx"], out[f"R{R}_cs_w"] = cs.indices, cs.weights
        sel = CoresetSelector(lambda E: E * 2.0, chunk_size=64, mesh=mesh).select(
            ex, 64, jax.random.PRNGKey(0))
        out[f"R{R}_sel_idx"], out[f"R{R}_sel_w"] = sel.indices, sel.weights
        out[f"R{R}_gram"] = np.asarray(DC.distributed_gram(jnp.asarray(X), mesh))
        out[f"R{R}_lev"] = np.asarray(DC.distributed_leverage(jnp.asarray(X), mesh))
        for name, v in zip(("G", "s1", "s2"), DC.distributed_scoring_stats(
                jnp.asarray(X), jnp.asarray(P), mesh)):
            out[f"R{R}_stats_{name}"] = np.asarray(v)
    jax.config.update("jax_enable_x64", True)
    cfg6 = M.MCTMConfig(J=2, degree=6)
    scaler6 = DataScaler.fit(Y6)
    for R in (2, 4):
        mesh = Mesh(np.array(jax.devices()[:R]), ("data",))
        r = DC.DistributedScoringEngine(cfg6, scaler6, mesh=mesh, chunk_size=64,
                                        gram_dtype="float64").score(
            jnp.asarray(Y6), method="l2-hull", hull_k=20, hull_key=hkey)
        out[f"R{R}_f64"], out[f"R{R}_f64_hull"] = r.scores, r.hull_rows
    np.savez(sys.argv[1], **out)
""")


def _selector_draw(ex, k_draw, normals):
    """The reference selector's sample draw, ``jax.random.choice(k_draw, p)``,
    on the port's single-host probabilities of the same selection (within
    ~1e-7 of the reference's, which moves no draw here: the test then holds
    the port's mesh selection to the reference's mesh selection whole)."""
    F = TS.ScoringEngine(featurize=lambda E: (double(E), double(E)), chunk_size=128,
                         rows_per_point=1, device="cpu").score(
        ex, method="l2-only", hull_k=13, hull_normals=normals)
    probs = F.scores / F.scores.sum()
    return np.asarray(jax.random.choice(k_draw, N, shape=(51,), replace=True,
                                        p=jnp.asarray(probs)))


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    Y = rng.random((N, 2)).astype(np.float32)
    w = (rng.random(N) * 3.0 + 0.1).astype(np.float32)
    Y6 = rng.standard_normal((N, 2)).astype(np.float32)
    X = rng.standard_normal((640, 12)).astype(np.float32)
    P = rng.standard_normal((640, 5)).astype(np.float32)
    ex = np.random.default_rng(0).standard_normal((N, 6)).astype(np.float32)
    hkey, skey = jax.random.PRNGKey(3), jax.random.PRNGKey(9)
    m = 4 * HULL_K

    def normals(key, d):
        return np.asarray(jax.random.normal(key, (m, d), jnp.float32))

    A, Ap = RM.basis_features(RM.MCTMConfig(J=2, degree=5), RB.DataScaler.fit(Y), jnp.asarray(Y))
    _, k_hull_b, _ = jax.random.split(jax.random.PRNGKey(7), 3)
    k_draw_sel, k_hull_sel = jax.random.split(jax.random.PRNGKey(0))
    normals_sel = np.asarray(jax.random.normal(k_hull_sel, (max(4 * 13, 8), 6), jnp.float32))
    return dict(
        Y=Y, w=w, Y6=Y6, ex=ex, X=X, P=P,
        look=(np.asarray(A).reshape(N, 12), np.asarray(Ap).reshape(2 * N, 6)),
        normals5=normals(hkey, 6), normals6=normals(hkey, 7),
        normals_build=normals(k_hull_b, 6),
        normals_sel=normals_sel,
        sel_draw=_selector_draw(ex, k_draw_sel, normals_sel),
        plan=tuple(np.asarray(p) for p in RS.OnePassSketched(SK).begin(N, 12, skey)[:2]),
        plan_q8=tuple(np.asarray(p) for p in RS.OnePassSketched(SK, proj_size=8).begin(
            N, 12, skey)),
    )


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def both(tmp_path_factory, inputs):
    """(reference results, {R: per-rank port results}, inputs)."""
    path = str(tmp_path_factory.mktemp("dist_ref") / "ref.npz")
    ref, port = run_reference_and_worlds(REFERENCE, path, score_all, inputs)
    return ref, port, inputs


@pytest.fixture(scope="module")
def single(both):
    """The port's single-host engine on the same inputs."""
    inp = both[2]
    scaler = DataScaler.fit(inp["Y"])
    eng = TS.ScoringEngine(cfg(), scaler, chunk_size=CHUNK, device="cpu")
    return {
        "two": eng.score(inp["Y"], method="l2-hull", hull_k=HULL_K,
                         hull_normals=inp["normals5"]),
        "one": eng.score(inp["Y"], method="l2-hull", hull_k=HULL_K,
                         hull_normals=inp["normals5"], sketch_size=SK, plan=inp["plan"]),
        "tps": eng.score(inp["Y"], method="l2-hull", hull_k=HULL_K,
                         hull_normals=inp["normals5"], strategy=TS.TwoPassSketched(SK),
                         plan=inp["plan"]),
    }


def _max(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def _hull_overlap(a, b) -> float:
    return len(set(a.tolist()) & set(b.tolist())) / max(len(b), 1)


@pytest.mark.parametrize("R", WORLDS)
@pytest.mark.parametrize("tag,tol", [("two", 1e-6), ("one", 2e-6)])
def test_identical_features_give_the_reference_hull(both, R, tag, tol):
    """On the same feature bits (a lookup featurize on both sides) the
    scores agree to the strategy's limit and the hull rows[:20] and
    ``exact_hull_points`` are the reference's."""
    ref, port, _ = both
    got = port[R][0]
    assert _max(got[f"look_{tag}"], ref[f"R{R}_look_{tag}"]) <= tol
    np.testing.assert_array_equal(got[f"look_{tag}_hull"][:20],
                                  ref[f"R{R}_look_{tag}_hull"][:20])
    np.testing.assert_array_equal(got[f"look_{tag}_exact"], ref[f"R{R}_look_{tag}_exact"])


@pytest.mark.parametrize("R", WORLDS)
def test_two_pass_matches_reference_and_single_host(both, single, R):
    """The MCTM featurize on each side (the bernstein kernel's plain version
    here): the scores to 1e-6; the hull rows are the port's single-host
    engine's, and ≥ 90% of the reference's (its ``jnp.power`` is not
    correctly rounded, and neighbouring derivative rows tie within f32)."""
    ref, port, _ = both
    got = port[R][0]
    assert _max(got["two"], ref[f"R{R}_two"]) <= 1e-6
    assert _max(got["two"], single["two"].scores) <= 1e-6
    np.testing.assert_array_equal(got["two_hull"][:20], single["two"].hull_rows[:20])
    assert _hull_overlap(got["two_exact"], ref[f"R{R}_two_exact"]) >= 0.9
    assert _max(got["two_w"], ref[f"R{R}_two_w"]) <= 5e-6


@pytest.mark.parametrize("R", WORLDS)
def test_one_pass_matches_reference_and_single_host(both, single, R):
    ref, port, _ = both
    got = port[R][0]
    assert _max(got["one"], ref[f"R{R}_one"]) <= 2e-6
    assert _max(got["one"], single["one"].scores) <= 2e-6
    np.testing.assert_array_equal(got["one_hull"][:20], single["one"].hull_rows[:20])
    assert _hull_overlap(got["one_exact"], ref[f"R{R}_one_exact"]) >= 0.9
    assert _max(got["one_q8_w"], ref[f"R{R}_one_q8_w"]) <= 5e-6
    # TwoPassSketched (the reference does not shard it): the single-host engine's
    assert _max(got["tps"], single["tps"].scores) <= 2e-6


@pytest.mark.parametrize("R", WORLDS)
def test_float64_gram_at_degree_6_matches_reference(both, R):
    ref, port, _ = both
    got = port[R][0]
    assert _max(got["f64"], ref[f"R{R}_f64"]) <= 1e-6
    assert _hull_overlap(got["f64_hull"][:20], ref[f"R{R}_f64_hull"][:20]) >= 0.9


def test_sketched_float64_is_refused():
    Y = np.random.default_rng(0).random((64, 2)).astype(np.float32)
    eng = TD.DistributedScoringEngine(cfg(), DataScaler.fit(Y), mesh=DataMesh(device="cpu"))
    with pytest.raises(NotImplementedError, match="single-host"):
        eng.score(Y, method="l2-only", generator=torch.Generator().manual_seed(0),
                  strategy=TS.OnePassSketched(SK, "float64"))


@pytest.mark.parametrize("R", WORLDS)
def test_build_coreset_matches_reference_on_every_rank(both, R):
    ref, port, _ = both
    ranks = port[R]
    k_sample = 80
    res = ranks[0]["build_res"]
    got = TC.coreset_from_scoring(res, N, 100, "l2-hull", 0.8, 0.0,
                                  draw=ref[f"R{R}_cs_idx"][:k_sample])
    # the sampled ids and weights; the hull points ≥ 90% (each side's own
    # featurize: see test_two_pass_matches_reference_and_single_host)
    np.testing.assert_array_equal(got.indices[:k_sample], ref[f"R{R}_cs_idx"][:k_sample])
    np.testing.assert_allclose(got.weights, ref[f"R{R}_cs_w"], rtol=1e-4)
    assert _hull_overlap(got.indices[k_sample:], ref[f"R{R}_cs_idx"][k_sample:]) >= 0.9
    for other in ranks[1:]:
        np.testing.assert_array_equal(other["build_res"].scores, res.scores)
        np.testing.assert_array_equal(other["gen_idx"], ranks[0]["gen_idx"])
        np.testing.assert_array_equal(other["gen_w"], ranks[0]["gen_w"])
    assert ranks[0]["gen_idx"].shape == (100,)


@pytest.mark.parametrize("R", WORLDS)
def test_coreset_selector_on_the_mesh_matches_reference(both, R):
    ref, port, inp = both
    ranks = port[R]
    np.testing.assert_array_equal(ranks[0]["sel_idx"], ref[f"R{R}_sel_idx"])
    np.testing.assert_allclose(ranks[0]["sel_w"], ref[f"R{R}_sel_w"], rtol=1e-4)
    for other in ranks[1:]:
        np.testing.assert_array_equal(other["sel_idx"], ranks[0]["sel_idx"])
        np.testing.assert_array_equal(other["sel_w"], ranks[0]["sel_w"])
    single = select(None, inp)
    np.testing.assert_array_equal(ranks[0]["sel_idx"], single[0])


@pytest.mark.parametrize("R", WORLDS)
def test_collective_census_one_fold_a_sweep_one_gather_pair(both, R):
    _, port, _ = both
    for rank in port[R]:
        for key in ("census_two", "census_one"):
            c = rank[key]
            assert c["fold"]["calls"] == 1, (key, c)
            assert c["hull_gather"]["calls"] == 2, (key, c)
            assert c["row_gather"]["calls"] == 1, (key, c)


@pytest.mark.parametrize("R", WORLDS)
def test_direction_argmax_ragged_and_primitives_match_reference(both, R):
    ref, port, inp = both
    got = port[R][0]
    for n, (a, want) in got["argmax"].items():
        np.testing.assert_array_equal(a, want, err_msg=f"n={n}")
        assert (a < n).all()
    assert got["empty_raises"]
    np.testing.assert_allclose(got["gram"], ref[f"R{R}_gram"], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got["lev"], ref[f"R{R}_lev"], rtol=1e-4, atol=1e-6)
    for name, g in zip(("G", "s1", "s2"), got["stats"]):
        np.testing.assert_allclose(g, ref[f"R{R}_stats_{name}"], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("R", WORLDS)
def test_stage_rows_keeps_the_rank_rows_and_scores_alike(both, R):
    _, port, _ = both
    for rank, got in enumerate(port[R]):
        a, b, ha, hb, rows, own = got["staged"]
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ha, hb)
        assert rows == own < N  # only this rank's rows
        assert got["short_raises"]


def test_world_one_is_the_single_host_engine(inputs):
    """A world of 1 (no process group) scores exactly as ``ScoringEngine``
    with the same chunk size, both strategies, and makes no collective."""
    inp = inputs
    scaler = DataScaler.fit(inp["Y"])
    mesh = DataMesh(device="cpu")
    eng = TD.DistributedScoringEngine(cfg(), scaler, mesh=mesh, chunk_size=CHUNK)
    single = TS.ScoringEngine(cfg(), scaler, chunk_size=CHUNK, device="cpu")
    for kw in ({}, {"sketch_size": SK, "plan": inp["plan"]}):
        a = eng.score(inp["Y"], method="l2-hull", hull_k=HULL_K,
                      hull_normals=inp["normals5"], **kw)
        b = single.score(inp["Y"], method="l2-hull", hull_k=HULL_K,
                         hull_normals=inp["normals5"], **kw)
        np.testing.assert_array_equal(a.scores, b.scores)
        np.testing.assert_array_equal(a.hull_rows, b.hull_rows)
        np.testing.assert_array_equal(a.gram, b.gram)
    assert mesh.census == {}


@pytest.mark.parametrize("ridge", [0.0, 1.0])
def test_gram_projection_matches_reference(ridge):
    """``scoring.gram_projection``: the leverage it gives (the eigenbasis'
    signs aside) is the reference's, on a rank-deficient Bernstein Gram."""
    rng = np.random.default_rng(2)
    Y = rng.random((500, 2)).astype(np.float32)
    A, _ = RM.basis_features(RM.MCTMConfig(J=2, degree=5), RB.DataScaler.fit(Y), jnp.asarray(Y))
    X = np.asarray(A).reshape(500, 12)
    G = X.T @ X
    rV, rinv = RS.gram_projection(jnp.asarray(G), ridge_reg=ridge)
    tV, tinv = TS.gram_projection(torch.tensor(G), ridge_reg=ridge)
    ref = np.sum(np.square(X @ np.asarray(rV)) * np.asarray(rinv), axis=1)
    got = torch.sum(torch.square(torch.tensor(X) @ tV) * tinv, dim=1).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=1e-6)


def test_shard_layout_matches_reference():
    """The row rule every sharded driver shares, the reference's (which
    reads only the mesh's shape)."""
    import types

    from repro.core import distributed_coreset as RD

    for R in (1, 2, 4, 8):
        mesh = DataMesh(world=R, group=None if R == 1 else object(), device="cpu")
        ref_mesh = types.SimpleNamespace(shape={"data": R})
        for n, chunk in ((1003, 64), (1003, None), (5, 2), (1, 64), (250_001, 16_384)):
            assert TD.shard_layout(mesh, "data", n, chunk) == RD.shard_layout(
                ref_mesh, "data", n, chunk)
