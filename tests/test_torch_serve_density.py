"""``repro_torch.serve.density`` and ``launch.serve_mctm`` against the JAX
package's, on the CPU (where each (kind, bucket) executable is the eager
function over static buffers; on the card a CUDA graph,
tests/test_torch_cuda.py).

Tolerances: log densities 1e-5 against the reference's on the same
parameters (the same f32 formula; the Bernstein powers are not correctly
rounded in the JAX package, tests/test_torch_bernstein.py), coalesced
against per-request 1e-6 (another batch width), samples on the reference's
own normals atol 1e-5 of the scaler's span (the grid inversion of
``mctm.sample``, tests/test_torch_mctm.py), a sample coalesced against
per-request exactly (per-row normals). Hot-swap atomicity is driven without
thread timing: publishes land between ticks, from the test's own thread or
from a worker that an event releases.
"""
import threading

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import mctm as RM  # noqa: E402
from repro.core.bernstein import DataScaler  # noqa: E402
from repro.serve import density as RD  # noqa: E402
from repro_torch.core import bernstein as TB  # noqa: E402
from repro_torch.core import mctm as TM  # noqa: E402
from repro_torch.serve import density as TD  # noqa: E402

RCFG = RM.MCTMConfig(J=2, degree=5)
TCFG = TM.MCTMConfig(J=2, degree=5)


@pytest.fixture(scope="module")
def fitted():
    key = jax.random.PRNGKey(0)
    Y = np.array(jax.random.normal(key, (400, 2)), np.float32)
    Y[:, 1] = 0.5 * Y[:, 0] + 0.8 * Y[:, 1]  # correlated dims
    scaler = DataScaler.fit(Y)
    params = RM.init_params(key, RCFG)
    return params, scaler, TB.DataScaler(low=scaler.low, high=scaler.high), Y


def _port(p):
    """The reference's parameters as the port's plain leaves (no autograd)."""
    return TM.ParamLeaves(torch.tensor(np.asarray(p.theta_raw)), torch.tensor(np.asarray(p.lam)))


def _versions(params0, n=4):
    """Strongly separated models: each version shifts the marginal transform
    and the copula coupling, so an answer identifies its version."""
    return [params0] + [RM.MCTMParams(theta_raw=params0.theta_raw + 0.5 * v,
                                      lam=params0.lam + 0.4 * v) for v in range(1, n)]


def _engine(params, tscaler, **kw):
    return TD.DensityServeEngine(TCFG, _port(params), tscaler, device="cpu", **kw)


def test_bucket_policy_matches_reference():
    for lo, hi in ((8, 256), (8, 100), (1, 1), (4, 16), (3, 50)):
        assert TD.bucket_sizes(lo, hi) == RD.bucket_sizes(lo, hi)
        sizes = TD.bucket_sizes(lo, hi)
        for m in range(1, hi + 1, 7):
            assert TD.bucket_for(m, sizes) == RD.bucket_for(m, sizes)
    assert TD.QUERY_KINDS == RD.QUERY_KINDS


def test_log_density_fn_matches_reference(fitted):
    params, scaler, tscaler, Y = fitted
    low, high = (np.asarray(a, np.float32) for a in (scaler.low, scaler.high))
    inv = np.asarray(scaler.inv_span, np.float32)
    ref = np.asarray(RD.make_log_density_fn(RCFG)(params, low, high, inv, jnp.asarray(Y)))
    got = TD.make_log_density_fn(TCFG)(_port(params), *(torch.tensor(a) for a in (low, high, inv)),
                                       torch.tensor(Y))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    # and it is mctm.log_density on the same rows, to the bit
    direct = TM.log_density(TCFG, _port(params), tscaler, torch.tensor(Y))
    assert torch.equal(got, direct)


@pytest.mark.parametrize("n_obs", [0, 1, 2])
def test_conditional_sampler_matches_reference_on_its_normals(fitted, n_obs):
    params, scaler, tscaler, Y = fitted
    base = jax.random.PRNGKey(3)
    seeds = np.arange(40, dtype=np.int32) * 7 + 1
    low, high = (np.asarray(a, np.float32) for a in (scaler.low, scaler.high))
    y_obs = Y[:40]
    nob = np.full(40, n_obs, np.int32)
    ref = np.asarray(RD.make_conditional_sample_fn(RCFG)(
        params, low, high, base, jnp.asarray(y_obs), jnp.asarray(nob), jnp.asarray(seeds)))
    z = np.asarray(jax.vmap(lambda s: jax.random.normal(jax.random.fold_in(base, s), (2,),
                                                        jnp.float32))(jnp.asarray(seeds)))
    got = TD.make_conditional_sample_fn(TCFG)(
        _port(params), torch.tensor(low), torch.tensor(high), torch.tensor(z),
        torch.tensor(y_obs), torch.tensor(nob)).numpy()
    span = high - low
    assert float(np.max(np.abs(got - ref) / span)) <= 1e-5
    np.testing.assert_allclose(got[:, :n_obs], y_obs[:, :n_obs], atol=1e-6)
    # through the engine, with the reference's normals handed in
    eng = _engine(params, tscaler, max_batch=16, min_bucket=4)
    reqs = eng.submit_sample(40, y_obs=y_obs, n_obs=n_obs, seeds=seeds.tolist(), normals=z)
    eng.run_until_drained()
    np.testing.assert_array_equal(np.stack([r.result for r in reqs]), got)


def test_coalesced_answers_equal_per_request(fitted):
    params, scaler, tscaler, Y = fitted
    big = _engine(params, tscaler, max_batch=32, min_bucket=8)
    reqs = big.submit_log_density(Y[:37])  # a full bucket and a padded 5-row tail
    big.run_until_drained()
    got = np.array([r.result for r in reqs])
    ref = np.asarray(RM.log_density(RCFG, params, scaler, jnp.asarray(Y[:37])))
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    one = _engine(params, tscaler, max_batch=1, min_bucket=1)
    r1 = one.submit_log_density(Y[:5])
    one.run_until_drained()
    np.testing.assert_allclose(np.array([r.result for r in r1]), got[:5], atol=1e-6, rtol=1e-6)
    seeds = [11, 7, 23, 5, 42, 8, 19]
    rb = big.submit_sample(len(seeds), seeds=seeds, y_obs=Y[0], n_obs=1)
    big.run_until_drained()
    batched = np.stack([r.result for r in rb])
    for i, s in enumerate(seeds):
        r = one.submit_sample(1, seeds=[s], y_obs=Y[0], n_obs=1)
        one.run_until_drained()
        np.testing.assert_array_equal(r[0].result, batched[i])


def test_conditional_sample_contract(fitted):
    params, scaler, tscaler, Y = fitted
    eng = _engine(params, tscaler, max_batch=16, min_bucket=4)
    r = eng.submit_sample(3, y_obs=Y[:3], n_obs=2, seeds=[1, 2, 3])
    eng.run_until_drained()
    np.testing.assert_allclose(np.stack([q.result for q in r]), Y[:3], atol=1e-6)
    r = eng.submit_sample(4, y_obs=Y[0], n_obs=1, seeds=[1, 2, 3, 4])
    eng.run_until_drained()
    out = np.stack([q.result for q in r])
    np.testing.assert_allclose(out[:, 0], Y[0, 0], atol=1e-6)
    assert len(np.unique(out[:, 1])) == 4
    r = eng.submit_sample(16, seeds=list(range(16)))
    eng.run_until_drained()
    out = np.stack([q.result for q in r])
    assert np.all(out >= scaler.low - 1e-5) and np.all(out <= scaler.high + 1e-5)


def test_zero_recaptures_after_warmup_and_across_publishes(fitted):
    params, scaler, tscaler, Y = fitted
    eng = _engine(params, tscaler, max_batch=32, min_bucket=8)
    warmed = eng.warmup()
    assert warmed == eng.compile_count == 2 * len(eng.buckets)
    rng = np.random.default_rng(0)
    for burst in (1, 5, 8, 9, 17, 32, 3):
        eng.submit_log_density(Y[rng.integers(0, len(Y), burst)])
        eng.submit_sample(burst, seeds=rng.integers(0, 1 << 30, burst).tolist())
        eng.step()
    eng.publish(_port(_versions(params)[2]))
    eng.submit_log_density(Y[:10])
    eng.run_until_drained()
    assert eng.compile_count == warmed == eng.stats()["compile_count"]
    # on the CPU the bernstein wrapper runs its plain version: no launches
    assert eng.version == 1 and eng.replayed_launches == {"bernstein": 0}


def _check_answers(reqs, refs):
    for j, r in enumerate(reqs):
        dists = [abs(r.result - refs[v][j]) for v in range(len(refs))]
        assert dists[r.version] <= 1e-5 * max(1.0, abs(refs[r.version][j])), (j, r.version,
                                                                              dists)
        assert int(np.argmin(dists)) == r.version


def test_hot_swap_atomicity_is_deterministic(fitted):
    """Publishes land between ticks (a worker thread released by an event
    publishes, then the test waits for it): every answer equals its
    recorded version's reference, never a blend; no query is dropped."""
    params0, scaler, tscaler, Y = fitted
    versions = _versions(params0)
    refs = [np.asarray(RM.log_density(RCFG, p, scaler, jnp.asarray(Y[:210]))) for p in versions]
    for v in range(1, len(versions)):
        assert np.abs(refs[v] - refs[0]).mean() > 1e-2  # the check can bite
    eng = _engine(params0, tscaler, max_batch=16, min_bucket=4)
    eng.warmup()
    go, published = threading.Event(), threading.Event()
    plan = {}

    def publisher():
        while True:
            go.wait()
            go.clear()
            v = plan.get("v")
            if v is None:
                return
            eng.publish(_port(versions[v]))
            published.set()

    th = threading.Thread(target=publisher)
    th.start()
    reqs = []
    try:
        for i, lo in enumerate(range(0, 210, 7)):
            reqs += eng.submit_log_density(Y[lo:lo + 7])
            if i in (5, 12, 20):  # publish while these rows wait in the queue
                plan["v"] = (5, 12, 20).index(i) + 1
                go.set()
                assert published.wait(10)
                published.clear()
            eng.step()
        eng.run_until_drained()
    finally:
        plan["v"] = None
        go.set()
        th.join(10)
    assert not th.is_alive()
    assert all(r.done for r in reqs)
    assert {r.version for r in reqs} == {0, 1, 2, 3}
    _check_answers(reqs, refs)
    assert eng.compile_count == 2 * len(eng.buckets)


def test_tick_serves_single_version(fitted):
    params0, scaler, tscaler, Y = fitted
    eng = _engine(params0, tscaler, max_batch=64, min_bucket=8)
    eng.warmup()
    reqs = eng.submit_log_density(Y[:30])
    eng.publish(_port(_versions(params0)[1]))
    reqs += eng.submit_log_density(Y[30:60])
    eng.step()  # ONE tick: the staged slot swaps in at its start
    assert all(r.done for r in reqs) and {r.version for r in reqs} == {1}


def test_publish_from_a_thread_never_blocks_a_tick(fitted):
    """A worker holds the engine's publish path busy (it publishes three
    versions, each paused mid-way on an event); ticks keep serving
    meanwhile, and every publish becomes visible."""
    params0, scaler, tscaler, Y = fitted
    eng = _engine(params0, tscaler, max_batch=16, min_bucket=4)
    eng.warmup()
    real = TD._slot_from
    entered, release = threading.Event(), threading.Event()

    def slow_slot(*args, **kwargs):
        entered.set()
        assert release.wait(10)
        return real(*args, **kwargs)

    done = threading.Event()

    def worker():
        for v in range(1, 4):
            eng.publish(_port(_versions(params0)[v]))
        done.set()

    TD._slot_from = slow_slot
    try:
        th = threading.Thread(target=worker)
        th.start()
        assert entered.wait(10)  # the worker sits inside publish, holding its lock
        served = 0
        for i in range(5):
            eng.submit_log_density(Y[i][None])
            # a tick that found the lock held would block here: it must not
            # wait on the worker's lock (it only takes it to swap a slot)
            served += _tick_with_timeout(eng, 5.0)
        release.set()
        th.join(10)
    finally:
        TD._slot_from = real
    assert served == 5 and done.is_set()
    eng.run_until_drained()
    assert eng.version == 3
    stalls = [e["visible_s"] - e["published_s"] for e in eng.swap_events if e["visible_s"]]
    assert stalls


def _tick_with_timeout(eng, seconds):
    out = {}
    th = threading.Thread(target=lambda: out.setdefault("n", eng.step()))
    th.start()
    th.join(seconds)
    assert not th.is_alive(), "a tick blocked behind a publish"
    return out["n"]


def test_refit_and_publish_matches_reference(fitted):
    """The same coreset and start: the refit's parameters within atol 1e-4
    (adam, tests/test_torch_fit.py's limit) and its logged NLL per point
    within rel 1e-5; one new version; the build path on the CPU too."""
    params0, scaler, tscaler, Y = fitted
    w = np.random.default_rng(1).uniform(0.5, 2.0, len(Y)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    reng = RD.DensityServeEngine(RCFG, params0, scaler, max_batch=8)
    RD.refit_and_publish(reng, scaler, coreset=(Y, w), key=key, method="adam", steps=30)
    init = RM.init_params(jax.random.split(key)[1], RCFG)
    eng = _engine(params0, tscaler, max_batch=8)
    v = TD.refit_and_publish(eng, tscaler, coreset=(Y, w), method="adam", steps=30,
                             init=TM.params_from_numpy(np.asarray(init.theta_raw),
                                                       np.asarray(init.lam), device="cpu"))
    assert v == 1 and len(eng.refit_log) == len(reng.refit_log) == 1
    got, ref = eng.refit_log[0], reng.refit_log[0]
    assert got["k"] == ref["k"] and got["fit_nll_pp"] == pytest.approx(ref["fit_nll_pp"],
                                                                       rel=1e-5)
    eng.run_until_drained()
    staged = eng.current_slot().params
    ref_slot = reng._staged or reng._slot
    for a, b in zip(TM.params_to_numpy(staged), (ref_slot.params.theta_raw, ref_slot.params.lam)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-4)
    th = eng.start_background_refit(tscaler, Y, 100, generator=torch.Generator().manual_seed(2),
                                    method="adam", steps=5, chunk_size=200)
    th.join(60)
    assert not th.is_alive() and eng.refit_log[-1]["k"] == 100
    assert eng.run_until_drained() == 0 and eng.version == 2


def test_serve_mctm_smoke_exits_zero():
    from repro_torch.launch import serve_mctm

    rec = serve_mctm.main(["--smoke", "--device", "cpu", "--n", "8000", "--k", "200",
                           "--steps", "20", "--queries", "512"])
    assert rec["dropped"] == 0 and rec["captures_after_warmup"] == 0
    assert rec["mixed_version_answers"] == 0 and set(rec["versions_served"]) >= {0, 1}
    assert rec["captures_warmup"] == 2 * len((8, 16, 32, 64))
