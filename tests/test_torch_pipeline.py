"""``repro_torch.data.pipeline`` and ``launch.stages`` against the JAX
package's, on the CPU.

* The loaders draw with numpy's ``SeedSequence([seed, step])`` on both
  sides: batches are held to the bit, in both sampling modes.
* ``with_backup_draws`` takes the reference's primary/backup decisions
  under the same injected clock.
* ``CoresetSelector`` on identical feature rows (the same numpy featurize
  on both sides) with the reference's draws handed to the port as a plan:
  the uniform ids, the k1 sample ids (``jax.random.choice`` over the
  reference's own probabilities), the CountSketch plan and the hull net.
  Ids exactly; weights rtol 2e-5 (the scores' f32 parity on identical
  features, tests/test_torch_scoring.py).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import scoring as RS  # noqa: E402
from repro.data import pipeline as RP  # noqa: E402
from repro.ft.failure import StragglerPolicy as RStraggler  # noqa: E402
from repro.launch import stages as RSt  # noqa: E402
from repro_torch.data import pipeline as TP  # noqa: E402
from repro_torch.ft.failure import StragglerPolicy as TStraggler  # noqa: E402
from repro_torch.launch import stages as TSt  # noqa: E402

N, VOCAB, SEQ, SK = 1500, 50, 12, 196


def _data(n=N, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, VOCAB, size=(n, SEQ)).astype(np.int32),
            "y": rng.normal(size=(n, 2)).astype(np.float32)}


def _same(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k


@pytest.mark.parametrize("sampling", ["uniform", "importance"])
def test_loaders_are_the_references_bits(sampling):
    data = _data()
    w = np.random.default_rng(1).gamma(0.5, 2.0, N).astype(np.float32)
    subset_idx = np.sort(np.random.default_rng(2).choice(N, 300, replace=False))
    r_sub = RP.WeightedSubset(subset_idx, w[subset_idx])
    t_sub = TP.WeightedSubset(subset_idx, w[subset_idx])
    for ref_fn, got_fn in (
        (RP.subset_loader(data, r_sub, 64, seed=3, sampling=sampling),
         TP.subset_loader(data, t_sub, 64, seed=3, sampling=sampling)),
        (RP.full_data_loader(data, w, 128, seed=4, sampling=sampling),
         TP.full_data_loader(data, w, 128, seed=4, sampling=sampling)),
    ):
        for step in (0, 1, 7, 1000):
            _same(got_fn(step), ref_fn(step))
    if sampling == "importance":
        b = TP.full_data_loader(data, w, 128, seed=4, sampling=sampling)(5)
        assert np.all(b["weights"] == np.float32(w.astype(np.float64).sum() / N))
    with pytest.raises(ValueError):
        TP.subset_loader(data, t_sub, 8, sampling="stratified")


def test_backup_draws_take_the_references_decisions():
    """An injected clock makes steps 1 and 4 miss the 50 ms deadline: both
    packages take the backup draw of the same step there, and the primary
    elsewhere."""
    data = _data()
    w = np.ones(N, np.float32)

    def clock_for(slow):
        state = {"calls": 0, "t": 0.0}

        def clock():
            # two reads a step: before and after the primary draw
            step = state["calls"] // 2
            if state["calls"] % 2 == 1:
                state["t"] += 0.2 if step in slow else 0.001
            state["calls"] += 1
            return state["t"]

        return clock

    sides = []
    for mod, policy in ((RP, RStraggler(deadline_ms=50.0)), (TP, TStraggler(deadline_ms=50.0))):
        primary = mod.full_data_loader(data, w, 32, seed=9)
        backup = mod.full_data_loader(data, w, 32, seed=9 + mod.BACKUP_SEED_OFFSET)
        fn = mod.with_backup_draws(primary, backup, policy, clock=clock_for({1, 4}))
        sides.append(([fn(i) for i in range(6)], primary, backup))
    (ref, rp, rb), (got, tp, tb) = sides
    assert TP.BACKUP_SEED_OFFSET == RP.BACKUP_SEED_OFFSET
    for i in range(6):
        _same(got[i], ref[i])
        _same(got[i], (tb if i in (1, 4) else tp)(i))


def test_sharded_loader_resumes_at_its_step():
    data = _data()
    fn = TP.full_data_loader(data, np.ones(N, np.float32), 16, seed=1)
    rfn = RP.full_data_loader(data, np.ones(N, np.float32), 16, seed=1)
    straight = []
    for b in TP.ShardedLoader(fn):
        straight.append(b)
        if len(straight) == 6:
            break
    loader = TP.ShardedLoader(fn, start_step=3)
    assert loader.state_dict(3) == RP.ShardedLoader(rfn).state_dict(3) == {"start_step": 3}
    resumed = []
    for b in loader:
        resumed.append(b)
        if len(resumed) == 3:
            break
    for a, b in zip(resumed, straight[3:]):
        _same(a, b)
    assert [int(b["_step"]) for b in straight] == list(range(6))
    ref = next(iter(RP.ShardedLoader(rfn, start_step=3)))
    _same(resumed[0], ref)


def _featurize(D, seed=5):
    emb = np.random.default_rng(seed).normal(size=(VOCAB, D)).astype(np.float32)

    def featurize(tokens):
        return emb[np.asarray(tokens)].mean(axis=1).astype(np.float32)

    return featurize


def _reference_plan(method, sketch, chunk, featurize, tokens, k, key):
    """The reference selector's draws for ``select(tokens, k, key)``, as a
    plan for the port's: the same key splits, and the k1 draw over the
    reference engine's own probabilities."""
    n = tokens.shape[0]
    if method == "uniform":
        return {"uniform": np.asarray(jax.random.choice(key, n, shape=(k,), replace=False))}
    alpha = 0.8
    k1 = int(np.floor(alpha * k)) if method == "l2-hull" else k
    k2 = k - k1 if method == "l2-hull" else 0
    if sketch:
        k_draw, k_hull, k_score = jax.random.split(key, 3)
    else:
        (k_draw, k_hull), k_score = jax.random.split(key), None

    def rfeat(Yc):
        F = jnp.asarray(featurize(np.asarray(Yc)), jnp.float32)
        return F, F

    res = RS.ScoringEngine(featurize=rfeat, chunk_size=chunk, rows_per_point=1).score(
        tokens, method="l2-only", hull_k=k2, hull_key=k_hull, sketch_size=sketch, key=k_score)
    probs = res.scores / res.scores.sum()
    plan = {"draw": np.asarray(jax.random.choice(k_draw, n, shape=(k1,), replace=True,
                                                 p=jnp.asarray(probs)))}
    D = int(np.asarray(featurize(tokens[:1])).shape[1])
    if sketch:
        plan["sketch"] = tuple(np.asarray(p) for p in RS.OnePassSketched(sketch).begin(
            n, D, k_score)[:2])
        if k2:
            plan["hull_normals"] = np.asarray(jax.random.normal(k_hull, (max(4 * k2, 8), D),
                                                                jnp.float32))
    elif k2:
        F = jnp.asarray(featurize(tokens), jnp.float32)
        z = jnp.zeros((D,), jnp.float32)
        _, s1, s2 = RS.pass1_update(jnp.zeros((D, D), jnp.float32), z, jnp.zeros((D, D)), F,
                                    F, jnp.ones((n,), jnp.float32))
        plan["hull_dirs"] = RS.directions_from_moments(k_hull, s1, s2, n, k2)
    return plan


@pytest.mark.parametrize("D", [8, 24])
@pytest.mark.parametrize("method,sketch", [("l2-hull", 0), ("l2-hull", SK), ("l2-only", 0),
                                           ("l2-only", SK), ("uniform", 0)])
def test_coreset_selector_matches_reference(D, method, sketch):
    tokens = _data()["tokens"]
    featurize = _featurize(D)
    k, key = 200, jax.random.PRNGKey(21)
    chunk = 500 if sketch else None  # the exact net needs the reference's one-chunk moments
    ref = RP.CoresetSelector(featurize, method=method, sketch_size=sketch,
                             chunk_size=chunk).select(tokens, k, key)
    plan = _reference_plan(method, sketch, chunk, featurize, tokens, k, key)
    got = TP.CoresetSelector(featurize, method=method, sketch_size=sketch, chunk_size=chunk,
                             device="cpu").select(tokens, k, plan=plan)
    assert got.size == ref.size == k
    np.testing.assert_array_equal(got.indices, ref.indices)
    np.testing.assert_allclose(got.weights, ref.weights, rtol=2e-5)
    if method == "l2-hull":
        assert np.unique(got.indices[int(0.8 * k):]).size == k - int(0.8 * k)


def test_coreset_selector_draws_from_a_generator_and_takes_tensors():
    """Without a plan the draws come from the generator (reproducible);
    tensor examples reach featurize as tensors; ``mesh=`` takes a world of 1
    to the same subset (worlds of 2 and 4: tests/test_torch_distributed_coreset.py)."""
    tokens = _data()["tokens"]
    emb = torch.tensor(np.random.default_rng(5).normal(size=(VOCAB, 8)).astype(np.float32))
    seen = []

    def featurize(t):
        seen.append(type(t))
        return emb[t.long()].mean(dim=1)

    sel = TP.CoresetSelector(featurize, sketch_size=SK, chunk_size=400, device="cpu")
    a = sel.select(torch.tensor(tokens), 100, generator=torch.Generator().manual_seed(1))
    b = sel.select(torch.tensor(tokens), 100, generator=torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.weights, b.weights)
    assert set(seen) == {torch.Tensor} and a.size == 100
    assert np.all(a.indices < N) and np.all(a.weights > 0)
    from repro_torch.distributed import DataMesh

    c = TP.CoresetSelector(featurize, sketch_size=SK, chunk_size=400,
                           mesh=DataMesh(device="cpu")).select(
        torch.tensor(tokens), 100, generator=torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(c.indices, a.indices)  # a world of 1: the same subset
    np.testing.assert_array_equal(c.weights, a.weights)
    with pytest.raises(ValueError):
        TP.CoresetSelector(featurize, method="kmeans", device="cpu")


@pytest.mark.parametrize("sketch", [0, SK])
def test_coreset_subset_loader_matches_reference(sketch):
    data = _data()
    featurize = _featurize(24)
    key = jax.random.PRNGKey(4)
    ref_fn = RSt.coreset_subset_loader(data, featurize, k=150, key=key, batch=32,
                                       sketch_size=sketch, chunk_size=None)
    plan = _reference_plan("l2-hull", sketch, None, featurize, data["tokens"], 150, key)
    got_fn = TSt.coreset_subset_loader(data, featurize, k=150, batch=32, plan=plan,
                                       sketch_size=sketch, device="cpu")
    for step in (0, 3):
        a, b = got_fn(step), ref_fn(step)
        for k in ("tokens", "y"):
            np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_allclose(a["weights"], b["weights"], rtol=2e-5)
