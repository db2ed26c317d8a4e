"""Merge & Reduce streaming in the port (``repro_torch.core.streaming``):
the reference's ``test_streaming.py`` and ``test_stream_maintainer.py``
cases that need no serving engine or mesh, on the port's own draws
(``stage_generator``); parity with the reference on the reference's own
draws through the plan hook — exact where the construction is exact (bucket
births, levels and sizes, total weight, the decayed closed form, the first
reduce's sampled rows), the hull rows of that reduce ≥ 90% shared (ROADMAP
Queue C 2: ``jnp.power``'s last bits), the final coreset held by the
reference test's NLL bound (rel 0.3 of the full-data NLL at fixed
parameters); the drift detector's state equal to the reference's after the
same observations; ``drift_window_nll`` within 1e-5 relative."""
import tempfile

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import mctm as RM  # noqa: E402
from repro.core import scoring as RS  # noqa: E402
from repro.core import streaming as RSt  # noqa: E402
from repro.core.bernstein import DataScaler  # noqa: E402
from repro.data.dgp import generate  # noqa: E402
from repro_torch.core import bernstein as TB  # noqa: E402
from repro_torch.core import mctm as TM  # noqa: E402
from repro_torch.core import streaming as TSt  # noqa: E402
from repro_torch.ft import FailureSimulator, InjectedFailure, get_ft_config  # noqa: E402


def _setup(n=3072, seed=0, degree=4, dgp="normal_mixture"):
    Y = np.asarray(generate(dgp, n, seed=seed), np.float32)
    scaler = DataScaler.fit(Y)
    return (TM.MCTMConfig(J=2, degree=degree), TB.DataScaler(low=scaler.low, high=scaler.high),
            Y, RM.MCTMConfig(J=2, degree=degree), scaler)


def _windows(Y, w):
    return [Y[i: i + w] for i in range(0, len(Y), w)]


def _maintainer(cfg, scaler, k, seed, **kw):
    return TSt.StreamingCoresetMaintainer(cfg, scaler, k, seed, device="cpu", **kw)


def _nll(cfg, scaler, params, Y, w=None):
    A, Ap = TM.basis_features(cfg, scaler, torch.as_tensor(np.asarray(Y, np.float32)))
    wt = None if w is None else torch.as_tensor(np.asarray(w, np.float32))
    with torch.no_grad():
        return float(TM.nll(cfg, params, A, Ap, wt))


# ------------------------------------------------------------ MergeReduce


def test_merge_reduce_tracks_stream():
    cfg, scaler, Y, _, _ = _setup(n=4096)
    mr = TSt.MergeReduceCoreset(cfg, scaler, k=128, seed=0, device="cpu")
    for rows in _windows(Y, 512):
        mr.push(rows)
    assert mr.n_seen == 4096
    res = mr.result()
    assert 0 < res.size <= 128
    assert res.weights.sum() == pytest.approx(4096, rel=0.35)
    assert len(mr._buckets) <= int(np.log2(4096 / 512)) + 2


def test_streaming_nll_close_to_full():
    cfg, scaler, Y, _, _ = _setup(n=2048, seed=1, dgp="bivariate_normal")
    mr = TSt.MergeReduceCoreset(cfg, scaler, k=256, seed=1, device="cpu")
    for rows in _windows(Y, 256):
        mr.push(rows)
    res = mr.result()
    params = TM.init_params(cfg, generator=torch.Generator().manual_seed(5), device="cpu")
    full = _nll(cfg, scaler, params, Y)
    assert _nll(cfg, scaler, params, res.Y, res.weights) == pytest.approx(full, rel=0.3)


def test_alpha_one_disables_hull_stage():
    cfg, scaler, Y, _, _ = _setup(n=1024, seed=3, dgp="bivariate_normal")
    mr = TSt.MergeReduceCoreset(cfg, scaler, k=64, seed=3, alpha=1.0, device="cpu")
    for rows in _windows(Y, 256):
        mr.push(rows)
    res = mr.result()
    assert 0 < res.size <= 64
    assert res.weights.sum() == pytest.approx(1024, rel=0.35)


def test_result_is_idempotent_and_peeking_is_free():
    """result() is a pure read: the same coreset twice, and a stream with
    interleaved result() calls ends where the unpeeked one does."""
    cfg, scaler, Y, _, _ = _setup(n=2048, seed=5)

    def run(peek):
        mr = TSt.MergeReduceCoreset(cfg, scaler, k=96, seed=5, device="cpu")
        for j, rows in enumerate(_windows(Y, 256)):
            mr.push(rows)
            if peek and j % 3 == 0:
                mr.result()
        return mr.result(), mr.result()

    (a, a2), (b, _) = run(False), run(True)
    for x, y in ((a, a2), (a, b)):
        np.testing.assert_array_equal(x.Y, y.Y)
        np.testing.assert_array_equal(x.weights, y.weights)


@pytest.mark.parametrize("sketch,calls", [(256, [128] * 4), (0, [128] * 8)])
def test_one_pass_sketched_reduce_streams_blocks_once(sketch, calls):
    """A 512-row block over 128-row chunks: the sketched reduce featurizes
    each row once, the exact two-pass reduce twice."""
    cfg, scaler, Y, _, _ = _setup(n=512, seed=7)
    mr = TSt.MergeReduceCoreset(cfg, scaler, k=128, seed=7, chunk_size=128,
                                sketch_size=sketch, device="cpu")
    seen = []
    base = mr._engine.featurize
    mr._engine.featurize = lambda Yc: (seen.append(int(Yc.shape[0])), base(Yc))[1]
    mr.push(Y)
    assert seen == calls


# ------------------------------------------------------------ the maintainer


def test_policy_validation_and_unported_options():
    cfg, scaler, _, _, _ = _setup(n=64)
    for kw in (dict(policy="nope"), dict(policy="sliding"), dict(policy="decayed", decay=1.0)):
        with pytest.raises(ValueError):
            _maintainer(cfg, scaler, 32, 0, **kw)
    # the serving loop is ported: a maintainer takes an engine and a detector
    from repro_torch.serve.density import DensityServeEngine

    eng = DensityServeEngine(cfg, TM.init_params(cfg, device="cpu"), scaler, device="cpu")
    m = _maintainer(cfg, scaler, 32, 0, serve_engine=eng, detector=TSt.DriftDetector(),
                    refit_kwargs={"steps": 3})
    assert m.serve_engine is eng and m.auto_trigger and m.refit_kwargs == {"steps": 3}
    from repro_torch.distributed import DataMesh

    mesh = DataMesh(device="cpu")
    assert _maintainer(cfg, scaler, 32, 0, drift_mesh=mesh).drift_mesh is mesh


def test_sliding_evicts_and_decayed_matches_closed_form():
    cfg, scaler, Y, _, _ = _setup()
    m = _maintainer(cfg, scaler, 64, 1, policy="sliding", window=3)
    for i, w in enumerate(_windows(Y, 384)):
        m.push(w)
        assert m.live_births() == list(range(max(0, i + 1 - 3), i + 1))
    assert m.total_weight() == pytest.approx(3 * 384, rel=1e-9)
    gamma, n = 0.6, 512
    m = _maintainer(cfg, scaler, 64, 2, policy="decayed", decay=gamma)
    for T, rows in enumerate(_windows(Y, n), start=1):
        m.push(rows)
        assert m.total_weight() == pytest.approx(n * (1 - gamma**T) / (1 - gamma), rel=1e-9)


@pytest.mark.parametrize("policy", ["insertion", "sliding", "decayed"])
def test_interrupted_resume_bit_identical(policy):
    """Killed at window 3 and resumed from its checkpoint, the maintainer
    reproduces the uninterrupted final coreset bit for bit; result() is
    idempotent."""
    cfg, scaler, Y, _, _ = _setup()
    kw = {"sliding": dict(window=2), "decayed": dict(decay=0.7)}.get(policy, {})
    kw.update(policy=policy, sketch_size=64)
    windows = _windows(Y, 512)
    ref = _maintainer(cfg, scaler, 96, 4, **kw)
    for rows in windows:
        ref.push(rows)
    rr = ref.result()
    np.testing.assert_array_equal(rr.Y, ref.result().Y)
    ft = get_ft_config()
    with tempfile.TemporaryDirectory() as d:
        ft.simulator = FailureSimulator().inject("streaming", 3)
        try:
            interrupts = 0
            m = _maintainer(cfg, scaler, 96, 4, ckpt_dir=d, **kw)
            done = 0
            while done < len(windows):
                try:
                    m.push(windows[done])
                    done = m.windows_done
                except InjectedFailure:
                    interrupts += 1
                    m = _maintainer(cfg, scaler, 96, 4, ckpt_dir=d, **kw)
                    done = m.resume()
        finally:
            ft.simulator = None
        ri = m.result()
    assert interrupts == 1 and m.n_seen == ref.n_seen
    np.testing.assert_array_equal(rr.Y, ri.Y)
    np.testing.assert_array_equal(rr.weights, ri.weights)


def test_state_dict_roundtrip_preserves_moments_and_detector():
    cfg, scaler, Y, _, _ = _setup()
    det = TSt.DriftDetector(eps=0.2, alpha=0.5, min_windows=2)
    det.observe(1.0)
    det.observe(1.05)
    m = _maintainer(cfg, scaler, 64, 5, sketch_size=64, detector=det)
    for rows in _windows(Y[:1536], 512):
        m.push(rows)
    assert m._moments is not None  # the two-round net's moments
    m2 = _maintainer(cfg, scaler, 64, 5, sketch_size=64,
                     detector=TSt.DriftDetector(eps=0.2, alpha=0.5, min_windows=2))
    m2.load_state(m.state_dict())
    assert (m2.windows_done, m2.n_seen) == (m.windows_done, m.n_seen)
    np.testing.assert_array_equal(m2.detector.state(), m.detector.state())
    np.testing.assert_array_equal(m2._moments[1], m._moments[1])
    a, b = m.result(), m2.result()
    np.testing.assert_array_equal(a.Y, b.Y)
    np.testing.assert_array_equal(a.weights, b.weights)


# --------------------------------------------------- parity on the reference's draws


def _reference_draws(key, sketch, k, alpha, d, oversample=4):
    """The plan hook: the reference's draws from fold_in(fold_in(key,
    window), stage), split as its ``_reduce`` splits them."""
    k1 = int(np.floor(alpha * k))
    k2 = k - k1

    def hook(window, stage, rows, probs):
        sub = jax.random.fold_in(jax.random.fold_in(key, window), stage)
        if sketch > 0:
            draw_key, hull_key, score_key = jax.random.split(sub, 3)
        else:
            (draw_key, hull_key), score_key = jax.random.split(sub), None
        if probs is None:
            out = {"hull_normals": np.asarray(
                jax.random.normal(hull_key, (max(oversample * k2, 8), d), jnp.float32))}
            if sketch > 0:
                out["plan"] = tuple(np.asarray(x) for x in RS.sketch_plan(score_key, rows, sketch))
            return out
        return {"draw": np.asarray(jax.random.choice(
            draw_key, rows, shape=(k1,), replace=True, p=jnp.asarray(probs)))}

    return hook


@pytest.mark.parametrize("policy,sketch", [("insertion", 64), ("sliding", 0), ("decayed", 64)])
def test_maintainer_matches_reference_on_its_draws(policy, sketch):
    cfg, scaler, Y, rcfg, rscaler = _setup()
    key, k, alpha = jax.random.PRNGKey(8), 96, 0.8
    k1 = int(np.floor(alpha * k))
    kw = {"sliding": dict(window=2), "decayed": dict(decay=0.7)}.get(policy, {})
    kw.update(policy=policy, sketch_size=sketch)
    ref = RSt.StreamingCoresetMaintainer(rcfg, rscaler, k, key, **kw)
    got = _maintainer(cfg, scaler, k, 0, plan_hook=_reference_draws(key, sketch, k, alpha,
                                                                     cfg.d), **kw)
    windows = _windows(Y, 512)
    for i, rows in enumerate(windows):
        ref.push(rows)
        got.push(rows)
        if i == 0:  # the first reduce: the same sampled rows, most hull rows shared
            rb, gb = ref.live_buckets()[0], got.live_buckets()[0]
            np.testing.assert_array_equal(gb.Y[:k1], rb.Y[:k1])
            shared = {tuple(r) for r in gb.Y[k1:]} & {tuple(r) for r in rb.Y[k1:]}
            assert len(shared) >= 0.9 * (k - k1)
        assert got.live_births() == ref.live_births()
        assert [(b.level, b.Y.shape[0]) for b in got.live_buckets()] == [
            (b.level, b.Y.shape[0]) for b in ref.live_buckets()]
        assert got.total_weight() == pytest.approx(ref.total_weight(), rel=1e-9)
    if policy == "decayed":
        T = len(windows)
        assert got.total_weight() == pytest.approx(512 * (1 - 0.7**T) / 0.3, rel=1e-9)
    res = got.result()
    params = TM.init_params(cfg, generator=torch.Generator().manual_seed(5), device="cpu")
    live = Y[-2 * 512:] if policy == "sliding" else Y
    wsum = float(res.weights.sum())
    full = _nll(cfg, scaler, params, live) / len(live)
    approx = _nll(cfg, scaler, params, res.Y, res.weights) / wsum
    if policy != "decayed":
        assert approx == pytest.approx(full, rel=0.3)
    assert wsum == pytest.approx(ref.result().weights.sum(), rel=1e-9)


# ------------------------------------------------------------------- drift


def test_drift_detector_state_matches_reference():
    seq = [(2.0, 0, None), (2.01, 0, None), (2.6, 0, None), (2.7, 0, None),
           (1.8, 1, 1.75), (1.76, 1, None), (1.9, 1, None)]
    ref, got = RSt.DriftDetector(eps=0.1, alpha=0.5), TSt.DriftDetector(eps=0.1, alpha=0.5)
    for nll, version, hint in seq:
        assert got.observe(nll, version, hint) == ref.observe(nll, version, hint)
        np.testing.assert_array_equal(got.state(), ref.state())
        assert (got.eps_hat, got.in_band) == (ref.eps_hat, ref.in_band)
    assert got.alerts == ref.alerts > 0
    fresh = TSt.DriftDetector(eps=0.1, alpha=0.5)
    fresh.load(got.state())
    assert fresh.observe(1.95) == got.observe(1.95)
    with pytest.raises(ValueError):
        TSt.DriftDetector(alpha=0.0)


def test_drift_window_nll_matches_reference():
    cfg, scaler, Y, rcfg, rscaler = _setup(n=1500)
    rp = RM.init_params(jax.random.PRNGKey(2), rcfg)
    tp = TM.params_from_numpy(np.asarray(rp.theta_raw), np.asarray(rp.lam), device="cpu")
    w = np.linspace(0.2, 2.0, 1500).astype(np.float32)
    for weights in (None, w):
        ref = RSt.drift_window_nll(rcfg, rscaler, rp, Y, weights, chunk=512)
        got = TSt.drift_window_nll(cfg, scaler, tp, Y, weights, chunk=512, device="cpu")
        assert got == pytest.approx(ref, rel=1e-5)
    shifted = TSt.drift_window_nll(cfg, scaler, tp, Y * 1.6 + 2 * Y.std(0), chunk=512,
                                   device="cpu")
    assert shifted > got
    from repro_torch.distributed import DataMesh

    # a world of 1: the same float as without a mesh (worlds of 2 and 4 are
    # held to the reference's mesh in tests/test_torch_mesh_fit.py)
    assert TSt.drift_window_nll(cfg, scaler, tp, Y, w, chunk=512,
                                mesh=DataMesh(device="cpu")) == got


def _drift_loop(maintainer, engine, windows):
    """Push each window; a triggered refit is joined and its publish served
    (a tick swaps it in) before the next window, as the reference's
    streaming drill waits for it."""
    for w in windows:
        maintainer.push(w)
        if maintainer.drift_log[-1]["triggered"]:
            engine._refit_thread.join(120)
            assert not engine._refit_thread.is_alive()
        engine.submit_log_density(w[:4])
        engine.run_until_drained()


def test_drift_refit_loop_matches_reference():
    """The maintainer's drift → refit → publish loop against the
    reference's: the same served model at version 0, 4 clean then 5
    shifted windows (rows·1.6 + 2·std). Both fire at the same window,
    start one refit there, publish it (the next window re-anchors on the
    refit's fit_nll_pp) and log the same number of refits; the served NLL
    of the shifted windows falls back into the band after the publish."""
    from repro.serve.density import DensityServeEngine as RDS
    from repro_torch.serve.density import DensityServeEngine as TDS

    cfg, scaler, Y, rcfg, rscaler = _setup(n=512 * 9, seed=3)
    std = Y.std(0)
    windows = [Y[i * 512:(i + 1) * 512] for i in range(9)]
    windows = windows[:4] + [w * 1.6 + 2 * std for w in windows[4:]]
    rp = RM.init_params(jax.random.PRNGKey(4), rcfg)
    from repro.core.mctm_fit import fit_mctm_streaming as rfit

    p0 = rfit(rcfg, rscaler, np.concatenate(windows[:2]), init=rp, steps=40, method="lbfgs").params
    tp0 = TM.params_from_numpy(np.asarray(p0.theta_raw), np.asarray(p0.lam), device="cpu")
    kw = dict(policy="sliding", window=3, sketch_size=32)
    det = dict(eps=0.1, alpha=0.5, min_windows=2)
    reng = RDS(rcfg, p0, rscaler, max_batch=8)
    ref = RSt.StreamingCoresetMaintainer(
        rcfg, rscaler, 96, jax.random.PRNGKey(2), serve_engine=reng,
        detector=RSt.DriftDetector(**det), refit_kwargs=dict(steps=20, method="lbfgs"), **kw)
    teng = TDS(cfg, tp0, scaler, max_batch=8, device="cpu")
    got = _maintainer(cfg, scaler, 96, 2, serve_engine=teng, detector=TSt.DriftDetector(**det),
                      refit_kwargs=dict(steps=20, method="lbfgs"), **kw)
    _drift_loop(ref, reng, windows)
    _drift_loop(got, teng, windows)
    fired = [e["window"] for e in got.drift_log if e["fired"]]
    assert fired and fired[0] == [e["window"] for e in ref.drift_log if e["fired"]][0] >= 4
    assert not any(e["fired"] for e in got.drift_log[:4])
    assert len(teng.refit_log) == len(reng.refit_log) == got.triggered == ref.triggered >= 1
    for a, b in zip(got.drift_log[:fired[0] + 1], ref.drift_log[:fired[0] + 1]):
        assert a["nll_pp"] == pytest.approx(b["nll_pp"], rel=1e-5)
    assert teng.version == reng.version >= 1
    after = [e for e in got.drift_log if e["version"] >= 1]
    assert after and after[-1]["eps_hat"] <= 0.1
