"""Keyword arguments of the reference that the port takes with the
reference's meaning, on the CPU against the JAX package: ``train_loop(
keep_losses=)``, ``drift_window_nll(axis=)`` and ``StreamingCoresetMaintainer(
drift_axis=)`` (an axis that is not the mesh's raises, as every ``axis=``
does), ``DistributedScoringEngine.score(n_valid=)`` on a world of 1 (a count
that is not the staged rows' raises). Scores rtol 2e-5 (ridge-lss: the two
Grams summed in another order), NLLs rtol 1e-6. ``fit_mctm(mesh=)`` and
``kv_allreduce(timeout_ms=)`` need worlds of ranks: tests/test_torch_mesh_fit.py
and tests/test_torch_mesh.py."""
import collections

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.core import distributed_coreset as RD  # noqa: E402
from repro.core import mctm as RM  # noqa: E402
from repro.core import streaming as RS  # noqa: E402
from repro.core.bernstein import DataScaler  # noqa: E402
from repro.train import loop as RL  # noqa: E402
from repro_torch.core import distributed_coreset as TD  # noqa: E402
from repro_torch.core import mctm as TM  # noqa: E402
from repro_torch.core import streaming as TS  # noqa: E402
from repro_torch.core.bernstein import DataScaler as TDataScaler  # noqa: E402
from repro_torch.distributed import DataMesh  # noqa: E402
from repro_torch.train import loop as TL  # noqa: E402

State = collections.namedtuple("State", ["step", "x"])


def _step(state, batch):
    x = state.x * 0.5 + batch["b"]
    return State(state.step + 1, x), {"loss": float(x), "grad_norm": abs(float(x))}


@pytest.mark.parametrize("keep", [True, False])
def test_train_loop_keep_losses(keep):
    """Every step's loss, or only the latest, as the reference keeps them."""
    batches = lambda i: {"b": float(i)}  # noqa: E731
    ref_state, ref = RL.train_loop(_step, State(0, 1.0), batches, 7, keep_losses=keep)
    got_state, got = TL.train_loop(_step, State(0, 1.0), batches, 7, keep_losses=keep)
    assert got == ref and len(got) == (7 if keep else 1)
    assert got_state == ref_state


@pytest.fixture(scope="module")
def mctm_case():
    rng = np.random.default_rng(21)
    Y = rng.standard_normal((700, 2)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, 700).astype(np.float32)
    scaler = DataScaler.fit(Y)
    cfg = RM.MCTMConfig(J=2, degree=5)
    p = RM.init_params(jax.random.PRNGKey(3), cfg)
    tp = TM.params_from_numpy(*(np.asarray(x) for x in p), device="cpu")
    tscaler = TDataScaler(low=np.asarray(scaler.low), high=np.asarray(scaler.high))
    return Y, w, cfg, scaler, p, TM.MCTMConfig(J=2, degree=5), tscaler, tp


def test_drift_window_nll_takes_the_axis(mctm_case):
    Y, w, cfg, scaler, p, tcfg, tscaler, tp = mctm_case
    ref = RS.drift_window_nll(cfg, scaler, p, Y, w, chunk=128, axis="data")
    plain = TS.drift_window_nll(tcfg, tscaler, tp, Y, w, chunk=128, axis="data", device="cpu")
    mesh = DataMesh(device="cpu")
    on_mesh = TS.drift_window_nll(tcfg, tscaler, tp, Y, w, chunk=128, mesh=mesh,
                                  axis=("data",))
    assert plain == pytest.approx(ref, rel=1e-6) and on_mesh == plain
    with pytest.raises(ValueError, match="axis"):
        TS.drift_window_nll(tcfg, tscaler, tp, Y, w, chunk=128, mesh=mesh, axis="model")


def test_maintainer_takes_the_drift_axis(mctm_case):
    _, _, cfg, scaler, _, tcfg, tscaler, _ = mctm_case
    RS.StreamingCoresetMaintainer(cfg, scaler, 50, jax.random.PRNGKey(0), drift_axis="data")
    mesh = DataMesh(device="cpu")
    m = TS.StreamingCoresetMaintainer(tcfg, tscaler, 50, drift_mesh=mesh, drift_axis="data",
                                      device="cpu")
    assert m.drift_axis == "data"
    with pytest.raises(ValueError, match="axis"):
        TS.StreamingCoresetMaintainer(tcfg, tscaler, 50, drift_mesh=mesh, drift_axis="model",
                                      device="cpu")


def test_distributed_score_takes_n_valid(mctm_case):
    """A staged input scored with its true count: the scores of the whole
    input, and the reference's (its staged rows padded to the layout); a
    count that is not the staged one raises."""
    Y, _, cfg, scaler, _, tcfg, tscaler, _ = mctm_case
    n = Y.shape[0]
    rmesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    reng = RD.DistributedScoringEngine(cfg, scaler, mesh=rmesh, chunk_size=128)
    ref = reng.score(reng.stage_rows([Y[:300], Y[300:]], n, 2), method="ridge-lss", n_valid=n)
    eng = TD.DistributedScoringEngine(tcfg, tscaler, mesh=DataMesh(device="cpu"),
                                      chunk_size=128)
    staged = eng.stage_rows([Y[:300], Y[300:]], n, 2)
    got = eng.score(staged, method="ridge-lss", n_valid=n)
    whole = eng.score(Y, method="ridge-lss")
    np.testing.assert_array_equal(got.scores, whole.scores)
    np.testing.assert_allclose(got.scores, np.asarray(ref.scores), rtol=2e-5)
    with pytest.raises(ValueError, match="n_valid"):
        eng.score(staged, method="ridge-lss", n_valid=n - 1)
