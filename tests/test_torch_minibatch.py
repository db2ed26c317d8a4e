"""The ``minibatch`` fit of the port against the JAX package's, on the CPU.

Both sides draw their batches through ``full_data_loader`` (numpy's
``SeedSequence([seed, step])``): the same rows every step. From the same
start, adam's arithmetic on the same batches gives params within atol 1e-4
and per-step losses within rtol 1e-4 (tests/test_torch_fit.py's limits:
f32 gradients summed in another order, amplified by Adam's normalization).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import conditional as RCo  # noqa: E402
from repro.core import mctm as RM  # noqa: E402
from repro.core import mctm_fit as RF  # noqa: E402
from repro.core.bernstein import DataScaler  # noqa: E402
from repro.data.dgp import generate  # noqa: E402
from repro_torch.core import bernstein as TB  # noqa: E402
from repro_torch.core import conditional as TCo  # noqa: E402
from repro_torch.core import mctm as TM  # noqa: E402
from repro_torch.core import mctm_fit as TF  # noqa: E402


@pytest.fixture(scope="module")
def data():
    Y = generate("normal_mixture", 3001, seed=5).astype(np.float32)
    scaler = DataScaler.fit(Y)
    w = np.random.default_rng(5).gamma(0.7, 2.0, Y.shape[0]).astype(np.float32)
    return Y, scaler, TB.DataScaler(low=scaler.low, high=scaler.high), w


def _port_params(p):
    return TM.params_from_numpy(np.asarray(p.theta_raw), np.asarray(p.lam), device="cpu")


def _close(got, ref, steps):
    th, lam = TM.params_to_numpy(got.params)
    np.testing.assert_allclose(th, np.asarray(ref.params.theta_raw), rtol=0, atol=1e-4)
    np.testing.assert_allclose(lam, np.asarray(ref.params.lam), rtol=0, atol=1e-4)
    assert got.losses.shape == (steps,)
    np.testing.assert_allclose(got.losses, ref.losses, rtol=1e-4)
    np.testing.assert_allclose(got.final_nll, ref.final_nll, rtol=1e-5)


@pytest.mark.parametrize("sampling", ["uniform", "importance"])
@pytest.mark.parametrize("chunk,batch", [(0, 512), (200, 500)])
def test_minibatch_fit_matches_reference(data, sampling, chunk, batch):
    """Weighted minibatch fits, one microbatch (chunk 0) and three (batch
    500 over chunks of 200: the size rounds up to 501), both sampling
    modes."""
    Y, scaler, tscaler, w = data
    cfg = RM.MCTMConfig(J=2, degree=6)
    init = RM.init_params(jax.random.PRNGKey(3), cfg)
    kw = dict(steps=25, lr=0.05, method="minibatch", batch_size=batch, sample_seed=11,
              sampling=sampling, chunk_size=chunk)
    ref = RF.fit_mctm_streaming(cfg, scaler, Y, w, init=init, **kw)
    got = TF.fit_mctm_streaming(TM.MCTMConfig(J=2, degree=6), tscaler, Y, w,
                                init=_port_params(init), device="cpu", **kw)
    _close(got, ref, 25)


def test_batch_size_and_plan_row_match_reference(data):
    _, _, _, w = data
    for bs, mb in ((1, 1), (4096, 1), (4097, 4), (10, 3)):
        assert TF.resolve_batch_size(bs, mb) == RF.resolve_batch_size(bs, mb)
    for n, chunk, mb, bs in ((3001, 0, None, None), (3001, 1000, None, 2500),
                             (100_000, 16_384, None, 4096), (3001, 256, 2, 999)):
        ww = np.ones(n, np.float32)
        got = TF.method_batch_plan("minibatch", n, ww, chunk, mb, bs)
        ref = RF.method_batch_plan("minibatch", n, ww, chunk, mb, bs)
        assert got[1:5] == tuple(ref[1:5])
        assert got[5] == pytest.approx(ref[5], rel=1e-7)
    # on a mesh the size rounds to microbatches × shards, as the reference's
    # (which reads only the mesh's shape)
    import types

    from repro_torch.distributed import DataMesh

    for shards, mb in ((2, 1), (4, 3)):
        mesh = DataMesh(world=shards, group=object(), device="cpu")
        assert TF.resolve_batch_size(1000, mb, mesh=mesh) == RF.resolve_batch_size(
            1000, mb, mesh=types.SimpleNamespace(shape={"data": shards}))
    with pytest.raises(ValueError, match="batch_size"):
        TF.fit_density_model(TF.MCTMDensityModel(TM.MCTMConfig(J=2)), _port_params(
            RM.init_params(jax.random.PRNGKey(0), RM.MCTMConfig(J=2))),
            {"Y": np.zeros((4, 2), np.float32), "weights": np.ones(4, np.float32)},
            optimizer=TF.default_fit_optimizer(0.1, 1), steps=1, method="minibatch",
            device="cpu")


def test_minibatch_resume_replays_the_straight_bits(data, tmp_path):
    """A crash at step 9 rolls back to the step-8 checkpoint; the resumed fit
    redraws steps 8.. from (seed, step) and ends on the straight run's
    bits."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.ft import FailureSimulator, get_ft_config

    Y, _, tscaler, w = data
    init = _port_params(RM.init_params(jax.random.PRNGKey(6), RM.MCTMConfig(J=2)))
    kw = dict(init=init, steps=16, method="minibatch", batch_size=256, sample_seed=2,
              chunk_size=0, device="cpu")
    cfg = TM.MCTMConfig(J=2)
    straight = TF.fit_mctm_streaming(cfg, tscaler, Y, w, **kw)
    ft = get_ft_config()
    ft.simulator = sim = FailureSimulator().inject("fit", 9)
    try:
        resumed = TF.fit_mctm_streaming(cfg, tscaler, Y, w, ckpt_every=4,
                                        checkpoint=CheckpointManager(str(tmp_path)), **kw)
    finally:
        ft.simulator = None
    assert sim.failures == [9]
    for a, b in zip(TM.params_to_numpy(resumed.params), TM.params_to_numpy(straight.params)):
        np.testing.assert_array_equal(a, b)


def test_straggler_backup_draws_match_reference(data):
    """A deadline no draw can meet: every step takes the backup draw (seed +
    BACKUP_SEED_OFFSET) in both packages, whose ft configs are set alike;
    the fits agree, and differ from the primary draws' fit."""
    from repro.ft import config as rcfg
    from repro_torch.ft import get_ft_config

    Y, scaler, tscaler, w = data
    cfg = RM.MCTMConfig(J=2, degree=6)
    init = RM.init_params(jax.random.PRNGKey(8), cfg)
    kw = dict(steps=12, lr=0.05, method="minibatch", batch_size=300, sample_seed=4,
              chunk_size=0)
    tft, rft = get_ft_config(), rcfg.get_ft_config()
    plain = TF.fit_mctm_streaming(TM.MCTMConfig(J=2, degree=6), tscaler, Y, w,
                                  init=_port_params(init), device="cpu", **kw)
    old = (tft.straggler_deadline_ms, rft.straggler_deadline_ms)
    tft.straggler_deadline_ms = rft.straggler_deadline_ms = 1e-9
    try:
        ref = RF.fit_mctm_streaming(cfg, scaler, Y, w, init=init, **kw)
        got = TF.fit_mctm_streaming(TM.MCTMConfig(J=2, degree=6), tscaler, Y, w,
                                    init=_port_params(init), device="cpu", **kw)
    finally:
        tft.straggler_deadline_ms, rft.straggler_deadline_ms = old
    _close(got, ref, 12)
    assert not np.allclose(got.losses, plain.losses)


def test_fit_cmctm_minibatch_matches_reference():
    rng = np.random.default_rng(0)
    n, F = 1500, 2
    X = rng.standard_normal((n, F))
    Y = X @ np.array([[1.5, -0.5], [0.3, 0.8]]).T + rng.standard_normal((n, 2))
    scaler = DataScaler.fit(Y)
    tscaler = TB.DataScaler(low=scaler.low, high=scaler.high)
    cfg = RCo.CMCTMConfig(J=2, n_features=F, degree=5)
    tcfg = TCo.CMCTMConfig(J=2, n_features=F, degree=5)
    key = jax.random.PRNGKey(4)
    ref = RCo.fit_cmctm(cfg, scaler, Y, X, key=key, steps=20, method="minibatch",
                        batch_size=400, chunk_size=200)
    normals = np.asarray(jax.random.normal(jax.random.split(key)[0], (2, 6), jnp.float32))
    init = TCo.init_cparams(tcfg, normals=normals, device="cpu")
    got = TCo.fit_cmctm(tcfg, tscaler, Y, X, init=init, steps=20, method="minibatch",
                        batch_size=400, chunk_size=200, device="cpu")
    assert got.losses.shape == (20,)
    np.testing.assert_allclose(got.losses, ref.losses, rtol=1e-4)
    for a, b in zip(TCo.cparams_to_numpy(got.params), ref.params):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=5e-4)
    assert got.final_nll == pytest.approx(ref.final_nll, rel=1e-5)


def test_driver_smoke_with_minibatch_fits(tmp_path):
    """``train_mctm --fit-method minibatch --device cpu --smoke`` runs to
    its end, the ratio in its band, with the batch size in its record."""
    from repro_torch.launch import train_mctm

    out = tmp_path / "rec.json"
    rec = train_mctm.run(train_mctm.parse_args([
        "--fit-method", "minibatch", "--ref-method", "adam", "--device", "cpu", "--smoke",
        "--n", "6001", "--ks", "300", "--steps", "60", "--out", str(out)]))
    assert rec["batch_size"] == 1024 and rec["fit_method"] == "minibatch"
    assert out.exists() and all(np.isfinite(r["ratio"]) for r in rec["per_k"])
