"""Fit layer of the port against the JAX package: the weighted adam fit from
the same initial parameters (carried by params_from_numpy), dense and
microbatched with a ragged tail — params atol 1e-4 and per-step losses rtol
1e-4 after 30 steps (f32 gradients summed in another order, amplified by
Adam's normalization) — and the streamed evaluator, rel 1e-6 (per-chunk f32
sums of the same terms)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import mctm as RM  # noqa: E402
from repro.core import mctm_fit as RF  # noqa: E402
from repro.core.bernstein import DataScaler  # noqa: E402
from repro.data.dgp import generate  # noqa: E402
from repro_torch.core import bernstein as TB  # noqa: E402
from repro_torch.core import mctm as TM  # noqa: E402
from repro_torch.core import mctm_fit as TF  # noqa: E402


@pytest.fixture(scope="module")
def data():
    Y = generate("normal_mixture", 1203, seed=3).astype(np.float32)
    scaler = DataScaler.fit(Y)
    w = np.random.default_rng(3).uniform(0.5, 4.0, Y.shape[0]).astype(np.float32)
    return Y, scaler, TB.DataScaler(low=scaler.low, high=scaler.high), w


def _port_params(p):
    return TM.params_from_numpy(np.asarray(p.theta_raw), np.asarray(p.lam), device="cpu")


@pytest.mark.parametrize("chunk,weighted", [(0, True), (400, True), (400, False)])
def test_adam_fit_matches_reference(data, chunk, weighted):
    Y, scaler, tscaler, w = data
    cfg = RM.MCTMConfig(J=2, degree=6)
    init = RM.init_params(jax.random.PRNGKey(chunk), cfg)
    weights = w if weighted else None
    ref = RF.fit_mctm_streaming(cfg, scaler, Y, weights, init=init, steps=30, lr=0.05,
                                chunk_size=chunk)
    got = TF.fit_mctm_streaming(TM.MCTMConfig(J=2, degree=6), tscaler, Y, weights,
                                init=_port_params(init), steps=30, lr=0.05,
                                chunk_size=chunk, device="cpu")
    th, lam = TM.params_to_numpy(got.params)
    np.testing.assert_allclose(th, np.asarray(ref.params.theta_raw), rtol=0, atol=1e-4)
    np.testing.assert_allclose(lam, np.asarray(ref.params.lam), rtol=0, atol=1e-4)
    assert got.losses.shape == (30,)
    np.testing.assert_allclose(got.losses, ref.losses, rtol=1e-4)
    np.testing.assert_allclose(got.final_nll, ref.final_nll, rtol=1e-5)


@pytest.mark.parametrize("chunk,eta", [(0, None), (500, 1e-9)])
def test_streamed_nll_matches_reference(data, chunk, eta):
    Y, scaler, tscaler, w = data
    cfg = RM.MCTMConfig(J=2, degree=6)
    p = RM.init_params(jax.random.PRNGKey(7), cfg)
    for weights in (None, w):
        ref = RF.streamed_nll(cfg, scaler, p, Y, weights, chunk=chunk, eta=eta)
        got = TF.streamed_nll(TM.MCTMConfig(J=2, degree=6), tscaler, _port_params(p), Y,
                              weights, chunk=chunk, eta=eta, device="cpu")
        assert abs(got - ref) <= 1e-6 * abs(ref)
    assert TF.likelihood_ratio(110.0, 100.0) == RF.likelihood_ratio(110.0, 100.0)
    assert TF.likelihood_ratio(-90.0, -100.0) == RF.likelihood_ratio(-90.0, -100.0)


def test_optimizer_schedule_and_methods(data):
    import jax.numpy as jnp

    from repro.optim import adamw as radamw
    from repro_torch.optim import adamw as tadamw

    for step in (0, 7, 29):
        assert TF.cosine_decay(0.05, 30)(step) == pytest.approx(
            float(RF.cosine_decay(0.05, 30)(jnp.asarray(step))), rel=1e-7)
    g = np.random.default_rng(0).normal(size=(3, 4)).astype(np.float32)
    ropt, topt = radamw(0.1), tadamw(0.1)
    rs = ropt.init({"a": jnp.zeros((3, 4))})
    ts = topt.init([torch.zeros(3, 4)])
    for step in range(3):
        ru, rs = ropt.update({"a": jnp.asarray(g * (step + 1))}, rs, {"a": jnp.zeros((3, 4))},
                             jnp.asarray(step))
        tu, ts = topt.update([torch.from_numpy(g * (step + 1))], ts, [torch.zeros(3, 4)], step)
        np.testing.assert_allclose(tu[0].numpy(), np.asarray(ru["a"]), rtol=1e-6)
    Y, _, tscaler, _ = data
    for method in ("lbfgs", "minibatch", "scipy-lbfgs"):
        with pytest.raises(NotImplementedError):
            TM.fit_mctm(TM.MCTMConfig(J=2), tscaler, Y[:10], method=method, device="cpu")
    with pytest.raises(ValueError):
        TM.fit_mctm(TM.MCTMConfig(J=2), tscaler, Y[:10], method="sgd", device="cpu")
