"""Supervised fit recovery in the port (``mctm_fit`` through ``train_loop``
and ``RunSupervisor``): an adam or lbfgs fit that crashes mid-run resumes
from its latest checkpoint and ends on the straight run's bits (the
reference's ``test_ft_recovery.py`` fit cases); a deterministically
poisoned objective drains the retry budget to the reference's abort
message, for both methods, beside the reference's own call on the same
input; ``fit_cmctm`` checkpoints and resumes."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import mctm as RM  # noqa: E402
from repro.core import mctm_fit as RFit  # noqa: E402
from repro.core.bernstein import DataScaler  # noqa: E402
from repro.ft.config import ft_overrides as r_overrides  # noqa: E402
from repro.optim import adamw as radamw  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core import bernstein as TB  # noqa: E402
from repro_torch.core import mctm as TM  # noqa: E402
from repro_torch.core import mctm_fit as TF  # noqa: E402
from repro_torch.ft import FailureSimulator, get_ft_config  # noqa: E402
from repro_torch.ft.config import ft_overrides  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402


def _fixture(n=512, seed=0):
    rng = np.random.default_rng(seed)
    Y = rng.normal(size=(n, 2)).astype(np.float32)
    scaler = DataScaler.fit(Y)
    tscaler = TB.DataScaler(low=scaler.low, high=scaler.high)
    cfg = TM.MCTMConfig(J=2, degree=4)
    model = TF.MCTMDensityModel(cfg, tscaler)
    p0 = TM.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    batch = {"Y": Y, "weights": np.ones(n, np.float32)}
    return model, p0, batch, scaler


def _fit(tmp_path, method, inject, **kw):
    """One fit with a checkpoint every 6 steps and the given injections;
    returns (params, losses, the injection log)."""
    model, p0, batch, _ = _fixture()
    ft = get_ft_config()
    sim = FailureSimulator()
    for phase, step in inject:
        sim.inject(phase, step)
    ft.simulator = sim if inject else None
    try:
        params, losses = TF.fit_density_model(
            model, p0, batch, method=method, steps=24, checkpoint=CheckpointManager(
                str(tmp_path), keep=2), ckpt_every=6, device="cpu", **kw)
    finally:
        ft.simulator = None
    return params, losses, sim.log


@pytest.mark.parametrize("method,inject", [
    ("adam", [("fit", 12)]),
    ("adam", [("fit", 13), ("checkpoint", 18)]),
    ("lbfgs", [("fit", 12)]),
    ("lbfgs", [("fit", 7), ("checkpoint", 18)]),
])
def test_injected_failure_recovers_bit_identical(tmp_path, method, inject):
    """Crash mid-fit (and mid-save) → the supervisor resumes from the
    latest atomic checkpoint and the deterministic replay lands on the
    straight run's parameters and final loss, bit for bit."""
    kw = {"optimizer": adamw(5e-2)} if method == "adam" else {}
    p_clean, l_clean, _ = _fit(tmp_path / "clean", method, [], **kw)
    p_rec, l_rec, log = _fit(tmp_path / "rec", method, inject, **kw)
    assert [(e["phase"], e["step"]) for e in log] == inject
    for f in p_clean._fields:
        assert torch.equal(getattr(p_clean, f), getattr(p_rec, f))
    assert l_rec[-1] == l_clean[-1]
    assert len(l_clean) == 24 and len(l_rec) < 24  # the final attempt's steps only


def test_resume_flag_restarts_from_the_latest_checkpoint(tmp_path):
    """``resume=True`` on a finished run's directory starts at its last
    step: no step runs, the saved parameters come back."""
    p_clean, _, _ = _fit(tmp_path, "adam", [], optimizer=adamw(5e-2))
    model, p0, batch, _ = _fixture()
    params, losses = TF.fit_density_model(
        model, p0, batch, optimizer=adamw(5e-2), steps=24,
        checkpoint=CheckpointManager(str(tmp_path), keep=2), resume=True, device="cpu")
    assert losses.size == 0
    for f in p_clean._fields:
        assert torch.equal(getattr(p_clean, f), getattr(params, f))


@pytest.mark.parametrize("method", ["adam", "lbfgs"])
def test_nan_data_crash_loops_to_the_reference_abort(method):
    """NaN data → a non-finite objective on every attempt → the retry
    budget drains and the supervisor aborts with its diagnostic, on both
    packages for the same input."""
    rng = np.random.default_rng(1)
    good = rng.normal(size=(64, 2)).astype(np.float32)
    bad_Y = np.full((64, 2), np.nan, np.float32)
    scaler = DataScaler.fit(good)
    rcfg = RM.MCTMConfig(J=2, degree=4)
    rbatch = {"Y": bad_Y, "weights": np.ones(64, np.float32)}
    rkw = {"optimizer": radamw(5e-2)} if method == "adam" else {}
    with r_overrides(max_retries=2, backoff_base_s=0.0), pytest.raises(RuntimeError) as ref:
        RFit.fit_density_model(RFit.MCTMDensityModel(rcfg, scaler),
                               RM.init_params(jax.random.PRNGKey(0), rcfg), rbatch, steps=4,
                               method=method, **rkw)
    model, p0, _, _ = _fixture(n=64)
    model = TF.MCTMDensityModel(TM.MCTMConfig(J=2, degree=4),
                                TB.DataScaler(low=scaler.low, high=scaler.high))
    kw = {"optimizer": adamw(5e-2)} if method == "adam" else {}
    with ft_overrides(max_retries=2, backoff_base_s=0.0), pytest.raises(RuntimeError) as got:
        TF.fit_density_model(model, p0, rbatch, steps=4, method=method, device="cpu", **kw)
    for ei in (ref, got):
        msg = str(ei.value)
        assert "retry budget exhausted after 3 attempts" in msg
        assert "non-finite" in msg and "NonFiniteError" in msg
    assert type(got.value.__cause__).__name__ == type(ref.value.__cause__).__name__


def test_adam_nonfinite_backs_off_the_lr(tmp_path, monkeypatch):
    """A step whose loss turns non-finite once (step 8) is rolled back: the
    retry resumes from the step-8 checkpoint with the LR halved, and the
    supervisor's event says 'nonfinite'."""
    from repro_torch.ft import RunSupervisor

    model, p0, batch, _ = _fixture()
    scales, events, calls = [], [], {"n": 0}
    real_scale, real_run, real_loss = TF.scale_updates, RunSupervisor.run, model.loss_fn

    def scale_updates(opt, scale):
        scales.append(scale)
        return real_scale(opt, scale)

    def loss_fn(params, b):
        out = real_loss(params, b)
        calls["n"] += 1
        return out * float("nan") if calls["n"] == 9 else out  # step 8's loss, once

    def run(self, fn):
        try:
            return real_run(self, fn)
        finally:
            events.extend(self.events)

    monkeypatch.setattr(TF, "scale_updates", scale_updates)
    monkeypatch.setattr(RunSupervisor, "run", run)
    model.loss_fn = loss_fn
    with ft_overrides(backoff_base_s=0.0):
        _, losses = TF.fit_density_model(
            model, p0, batch, optimizer=adamw(5e-2), steps=12, device="cpu",
            checkpoint=CheckpointManager(str(tmp_path)), ckpt_every=4)
    assert scales == [1.0, 0.5]
    assert [e["kind"] for e in events] == ["nonfinite"]
    assert "step 8" in events[0]["error"]
    assert np.all(np.isfinite(losses)) and len(losses) == 4


def test_fit_cmctm_lbfgs_checkpoint_and_resume(tmp_path):
    """The conditional fit's lbfgs mode through the same machinery: a crash
    at iteration 5 resumes from iteration 4 and ends on the straight fit's
    bits."""
    from repro_torch.core import conditional as TCo

    rng = np.random.default_rng(2)
    X = rng.normal(size=(200, 1)).astype(np.float32)
    Y = (rng.normal(size=(200, 2)) + X).astype(np.float32)
    tscaler = TB.DataScaler.fit(Y)
    cfg = TCo.CMCTMConfig(J=2, degree=4, n_features=1)
    init = TCo.init_cparams(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    common = dict(init=init, steps=10, method="lbfgs", device="cpu")
    straight = TCo.fit_cmctm(cfg, tscaler, Y, X, **common)
    ft = get_ft_config()
    ft.simulator = FailureSimulator().inject("fit", 5)
    try:
        with ft_overrides(backoff_base_s=0.0):
            got = TCo.fit_cmctm(cfg, tscaler, Y, X, checkpoint=CheckpointManager(str(tmp_path)),
                                ckpt_every=4, **common)
    finally:
        ft.simulator = None
    for a, b in zip(straight.params, got.params):
        assert torch.equal(a, b)
    assert got.final_nll == straight.final_nll
