"""The port's streaming-HVP L-BFGS (``mctm_fit``, ``method="lbfgs"``) and the
dense ``scipy-lbfgs`` oracle against the JAX package, on the CPU.

- Parity of the two fits from one start: ``test_torch_lbfgs_parity.py``
  (a file of its own, so that xdist runs its long case beside this file).
- The reference's lbfgs tests (``tests/test_mctm_fit.py``), ported: the
  streaming fit matches the scipy oracle (rel < 1e-3), a counting featurize
  never sees more than one chunk, the weighted objective and the latch,
  and the sweep census. A non-finite loss ends, on both packages, in the
  fault-tolerance supervisor's "retry budget exhausted" diagnostic.
- The drivers: ``repro_torch.launch.train_mctm`` and ``repro.launch.
  train_mctm`` at ``--smoke`` size (n = 10,001), default ``--ref-method``
  (lbfgs), give ``full_nll_per_point`` within 1e-4 relative (measured
  3e-5: the two start from different random initial parameters and stop
  at gtol 1e-5)."""
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_thread  # noqa: E402,F401

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import mctm as RM  # noqa: E402
from repro.core import mctm_fit as RF  # noqa: E402
from repro.core.bernstein import DataScaler  # noqa: E402
from repro_torch.core import bernstein as TB  # noqa: E402
from repro_torch.core import mctm as TM  # noqa: E402
from repro_torch.core import mctm_fit as TF  # noqa: E402


def _gaussian(n=2000, seed=0, rho=0.7):
    rng = np.random.default_rng(seed)
    L = np.linalg.cholesky(np.array([[1, rho], [rho, 1]]))
    Y = (rng.standard_normal((n, 2)) @ L.T).astype(np.float32)
    scaler = DataScaler.fit(Y)
    return Y, scaler, TB.DataScaler(low=scaler.low, high=scaler.high)


def _port(p):
    return TM.params_from_numpy(np.asarray(p.theta_raw), np.asarray(p.lam), device="cpu")


CFG = dict(J=2, degree=5)


def test_scipy_oracle_matches_reference():
    """The dense oracle itself: the port's ``_scipy_lbfgs_fit`` and the
    reference's reach the same optimum from the same start (measured 4e-5
    relative: L-BFGS-B stops at its own tolerance on f32 objectives)."""
    Y, scaler, tscaler = _gaussian(n=500)
    init = RM.init_params(jax.random.PRNGKey(0), RM.MCTMConfig(**CFG))
    ref = RM.fit_mctm(RM.MCTMConfig(**CFG), scaler, Y, init=init, method="scipy-lbfgs")
    got = TM.fit_mctm(TM.MCTMConfig(**CFG), tscaler, Y, init=_port(init), method="scipy-lbfgs",
                      device="cpu")
    assert abs(got.final_nll - ref.final_nll) <= 1e-4 * abs(ref.final_nll)


def test_lbfgs_streaming_matches_scipy_dense_oracle():
    """The streaming-HVP L-BFGS reaches the optimum of the dense small-n
    scipy oracle (``mctm._scipy_lbfgs_fit``)."""
    Y, _, tscaler = _gaussian(n=500)
    cfg = TM.MCTMConfig(**CFG)
    init = TM.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    dense = TM.fit_mctm(cfg, tscaler, Y, init=init, steps=500, method="scipy-lbfgs", device="cpu")
    stream = TM.fit_mctm(cfg, tscaler, Y, init=init, steps=150, method="lbfgs", chunk_size=128,
                         device="cpu")
    rel = abs(dense.final_nll - stream.final_nll) / abs(dense.final_nll)
    assert rel < 1e-3, (dense.final_nll, stream.final_nll)


def _counting_featurize(cfg, scaler, calls):
    from repro_torch.core.scoring import _mctm_featurize

    base = _mctm_featurize(cfg, scaler)

    def feat(Yc):
        calls.append(int(Yc.shape[0]))
        return base(Yc)

    return feat


def test_lbfgs_never_materializes_full_basis():
    """The lbfgs oracles — loss, grad and the curvature-pair HVP — all run
    the microbatched chunk driver: with chunk_size < n no featurize call
    sees more than one chunk of rows."""
    Y, _, tscaler = _gaussian(n=1000)
    cfg = TM.MCTMConfig(**CFG)
    calls: list = []
    fit = TF.fit_mctm_streaming(
        cfg, tscaler, Y, steps=12, method="lbfgs", chunk_size=128,
        generator=torch.Generator().manual_seed(0),
        featurize=_counting_featurize(cfg, tscaler, calls), device="cpu",
    )
    assert len(calls) >= 12
    assert max(calls) <= 128
    assert np.isfinite(fit.final_nll)


def test_lbfgs_weighted_objective_and_early_stop():
    """Weighted lbfgs optimizes Σ w·nll (final NLL is the weighted nll at the
    fitted parameters), and a converged run latches: the losses go flat,
    and a longer run from the same start changes nothing."""
    Y, _, tscaler = _gaussian(n=400)
    cfg = TM.MCTMConfig(**CFG)
    w = np.random.default_rng(2).random(400).astype(np.float32) * 3 + 0.1
    init = _port(RM.init_params(jax.random.PRNGKey(4), RM.MCTMConfig(**CFG)))
    kw = dict(weights=w, method="lbfgs", chunk_size=128, gtol=5e-2, init=init, device="cpu")
    fit = TF.fit_mctm_streaming(cfg, tscaler, Y, steps=120, **kw)
    A, Ap = TM.basis_features(cfg, tscaler, torch.as_tensor(Y))
    with torch.no_grad():
        dense = float(TM.nll(cfg, fit.params, A, Ap, torch.as_tensor(w)))
    assert abs(dense - fit.final_nll) / abs(dense) < 1e-5
    assert len(fit.losses) == 120
    assert fit.losses[-1] == fit.losses[-20]
    assert TF.LAST_LBFGS_SWEEPS["iters"] < 100
    longer = TF.fit_mctm_streaming(cfg, tscaler, Y, steps=200, **kw)
    np.testing.assert_array_equal(TM.params_to_numpy(fit.params)[0],
                                  TM.params_to_numpy(longer.params)[0])


def test_lbfgs_fused_linesearch_two_sweeps_per_iter():
    """The fused value-and-grad Armijo oracle and the gradient carry hold the
    streamed pass count near 2 sweeps an iteration (1 fused line-search
    sweep + 1 HVP)."""
    rng = np.random.default_rng(0)
    Y = rng.normal(size=(2000, 2)).astype(np.float32)
    scaler = DataScaler.fit(Y)
    tscaler = TB.DataScaler(low=scaler.low, high=scaler.high)
    init = _port(RM.init_params(jax.random.PRNGKey(1), RM.MCTMConfig(**CFG)))
    fit = TF.fit_mctm_streaming(TM.MCTMConfig(**CFG), tscaler, Y, init=init, steps=40,
                                method="lbfgs", chunk_size=512, device="cpu")
    assert np.isfinite(fit.final_nll)
    s = dict(TF.LAST_LBFGS_SWEEPS)
    assert s["iters"] > 10
    assert s["hvp"] <= s["iters"]
    assert (s["vg"] + s["hvp"]) / s["iters"] <= 2.5, s
    assert s["vg"] <= 1.5 * s["iters"] + 1, s


def test_lbfgs_non_finite_loss_raises():
    """An infinite weight makes the objective NaN on every attempt: both
    packages raise NonFiniteError at the failing step, retry it and end in
    the supervisor's RuntimeError naming the exhausted budget and the
    non-finite signal."""
    from repro.ft.config import ft_overrides as r_overrides
    from repro_torch.ft.config import ft_overrides as t_overrides

    Y, scaler, tscaler = _gaussian(n=300)
    w = np.ones(300, np.float32)
    w[7] = np.inf
    msgs = []
    with r_overrides(max_retries=2, backoff_base_s=0.0), pytest.raises(RuntimeError) as ei:
        RF.fit_mctm_streaming(RM.MCTMConfig(**CFG), scaler, Y, w, steps=5, method="lbfgs",
                              chunk_size=128, key=jax.random.PRNGKey(0))
    msgs.append(str(ei.value))
    with t_overrides(max_retries=2, backoff_base_s=0.0), pytest.raises(RuntimeError) as ei:
        TF.fit_mctm_streaming(TM.MCTMConfig(**CFG), tscaler, Y, w, steps=5, method="lbfgs",
                              chunk_size=128, generator=torch.Generator().manual_seed(0),
                              device="cpu")
    msgs.append(str(ei.value))
    for msg in msgs:
        assert "retry budget exhausted after 3 attempts" in msg
        assert "non-finite" in msg and "NonFiniteError" in msg


def test_streamed_oracles_sum_the_microbatches():
    """value_and_grad, value and hvp over 4 microbatches equal one
    microbatch over the same rows (f32, rtol 1e-5), and the HVP matches a
    float64 finite difference of the gradient."""
    Y, _, tscaler = _gaussian(n=512)
    cfg = TM.MCTMConfig(**CFG)
    p = TM.init_params(cfg, generator=torch.Generator().manual_seed(5), device="cpu")
    params = (p.theta_raw.detach(), p.lam.detach() + 0.1)
    vec = (torch.randn(p.theta_raw.shape, generator=torch.Generator().manual_seed(6)),
           torch.randn(p.lam.shape, generator=torch.Generator().manual_seed(7)))
    batch = {"Y": torch.as_tensor(Y), "weights": torch.ones(512)}
    model = TF.MCTMDensityModel(cfg, tscaler, norm=512.0)
    one, four = TF.make_streamed_oracles(model, 1), TF.make_streamed_oracles(model, 4)
    (l1, g1), (l4, g4) = one[0](params, batch), four[0](params, batch)
    torch.testing.assert_close(l4, l1, rtol=1e-5, atol=0)
    for a, b in zip(g4, g1):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(four[1](params, batch), l1, rtol=1e-5, atol=0)
    h1, h4 = one[2](params, vec, batch), four[2](params, vec, batch)
    for a, b in zip(h4, h1):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    eps = 1e-4
    p64 = [t.double() for t in params]
    model64 = TF.MCTMDensityModel(cfg, tscaler, norm=512.0)
    A, Ap = model64.features(batch)
    b64 = {"A": A.double(), "Ap": Ap.double(), "weights": torch.ones(512, dtype=torch.float64)}

    def grad64(shift):
        leaves = [(t + shift * v.double()).requires_grad_(True) for t, v in zip(p64, vec)]
        return torch.autograd.grad(model64.loss_fn(TM.ParamLeaves(*leaves), b64), leaves)

    fd = [(a - b) / (2 * eps) for a, b in zip(grad64(eps), grad64(-eps))]
    for a, b in zip(h1, fd):
        torch.testing.assert_close(a.double(), b, rtol=2e-3, atol=2e-4)


def test_method_batch_plan_normalizers_match_reference():
    w = np.random.default_rng(0).uniform(0.5, 2.0, 1001).astype(np.float32)
    for method in ("adam", "lbfgs"):
        got = TF.method_batch_plan(method, 1001, w, 256, None)
        ref = RF.method_batch_plan(method, 1001, w, 256, None)
        assert got[1:5] == (ref[1], ref[2], ref[3], ref[4])
        assert got[5] == pytest.approx(ref[5], rel=1e-7)
    # the minibatch row (ported with data/pipeline.py): batch size and normalizer
    for bs, mb in ((None, None), (500, None), (777, 3), (5000, None)):
        got = TF.method_batch_plan("minibatch", 1001, w, 256, mb, bs)
        ref = RF.method_batch_plan("minibatch", 1001, w, 256, mb, bs)
        assert got[1:5] == (ref[1], ref[2], ref[3], ref[4])
        assert got[5] == pytest.approx(ref[5], rel=1e-7)


def test_driver_full_nll_matches_reference(tmp_path):
    from repro.launch import train_mctm as R
    from repro_torch.launch import train_mctm as T

    argv = ["--smoke", "--n", "10001", "--ks", "300"]
    targs = T.parse_args(argv + ["--device", "cpu"])
    assert targs.ref_method == "lbfgs" and targs.gtol == 1e-5
    ref = R.run(R.parse_args(argv + ["--out", str(tmp_path / "ref.json")]))
    got = T.run(targs)
    assert got["ref_method"] == ref["ref_method"] == "lbfgs"
    a, b = got["full_nll_per_point"], ref["full_nll_per_point"]
    assert abs(a - b) <= 1e-4 * abs(b), (a, b)
