"""The port's fit layer and evaluators on gloo worlds of 2 and 4 CPU ranks
against the JAX package's on meshes of 2 and 4 fake CPU devices, from the
same parameters (carried by ``params_from_numpy``), on a ragged n = 1,003
(rows padded to microbatches × shards; the evaluators' shards and chunks
ragged): ``streamed_nll(mesh=)``, ``coreset_epsilon(mesh=)`` and
``drift_window_nll(mesh=)`` rtol 1e-6 (per-chunk f32 sums of the same
terms, in another order); ``fit_mctm_streaming(mesh=)`` adam (20 steps) and
minibatch (10 steps of 256 drawn rows, the reference's draws) with
tests/test_torch_fit.py's limits (params atol 1e-4, losses rtol 1e-4, final
NLL rtol 1e-5), lbfgs (10 iterations) with test_torch_lbfgs.py's (the first
5 losses rtol 1e-5, the final NLL 1e-4 relative); ``fit_cmctm(mesh=)`` with
test_torch_conditional.py's (leaves atol 5e-4, final NLL rtol 1e-5);
``fit_mctm(mesh=)`` (adam) as ``fit_mctm_streaming``, and
``drift_window_nll(axis=)`` refusing an axis that is not the mesh's. Every
rank ends on the same bits, each step or oracle sweep folds once, and the
world-R fits stay within the same limits of the port's single-device fits.
"""

import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_thread  # noqa: E402,F401

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import conditional as RCo  # noqa: E402
from repro.core import mctm as RM  # noqa: E402
from repro.core.bernstein import DataScaler  # noqa: E402
from repro_torch.core import mctm as TM  # noqa: E402
from repro_torch.core.bernstein import DataScaler as TDataScaler  # noqa: E402
from repro_torch.core import mctm_fit as TF  # noqa: E402
from repro_torch.distributed import DataMesh  # noqa: E402
from torch_mesh_ranks import WORLDS, cfg, fit_all, run_reference_and_worlds  # noqa: E402

REFERENCE = """
import sys
import jax, numpy as np
from jax.sharding import Mesh
from repro.core import mctm as M, mctm_fit as F, conditional as C, streaming as S
from repro.core.bernstein import DataScaler

inp = dict(np.load(sys.argv[2]))
out = {}
Y, w = inp["Y"], inp["w"]
cfg = M.MCTMConfig(J=2, degree=5)
scaler = DataScaler.fit(Y)
p0, p1 = M.init_params(jax.random.PRNGKey(1), cfg), M.init_params(jax.random.PRNGKey(2), cfg)
ccfg = C.CMCTMConfig(J=2, n_features=2, degree=5)
cscaler = DataScaler.fit(inp["Yc"])
for R in (2, 4):
    mesh = Mesh(np.array(jax.devices()[:R]), ("data",))
    out[f"R{R}_nll"] = F.streamed_nll(cfg, scaler, p0, Y, w, chunk=100, mesh=mesh)
    out[f"R{R}_eps"] = F.coreset_epsilon(cfg, scaler, Y, Y[:200], w[:200] * 5, [p0, p1],
                                         chunk=100, mesh=mesh)
    out[f"R{R}_drift"] = S.drift_window_nll(cfg, scaler, p0, Y, w, chunk=100, mesh=mesh)
    out[f"R{R}_bs"] = F.resolve_batch_size(1000, 3, mesh)
    for meth, steps in (("adam", 20), ("lbfgs", 10), ("minibatch", 10)):
        f = F.fit_mctm_streaming(cfg, scaler, Y, w, init=p0, steps=steps, method=meth,
                                 chunk_size=300, batch_size=256, mesh=mesh)
        out[f"R{R}_{meth}_losses"] = f.losses
        out[f"R{R}_{meth}_theta"] = np.asarray(f.params.theta_raw)
        out[f"R{R}_{meth}_lam"] = np.asarray(f.params.lam)
        out[f"R{R}_{meth}_final"] = f.final_nll
    if R == 2:
        f = M.fit_mctm(cfg, scaler, Y, w, init=p0, steps=20, method="adam", chunk_size=300,
                       mesh=mesh)
        out["R2_fit_mctm_losses"] = f.losses
        out["R2_fit_mctm_theta"] = np.asarray(f.params.theta_raw)
        out["R2_fit_mctm_lam"] = np.asarray(f.params.lam)
        out["R2_fit_mctm_final"] = f.final_nll
    f = C.fit_cmctm(ccfg, cscaler, inp["Yc"], inp["Xc"], weights=w, key=jax.random.PRNGKey(4), steps=20,
                    chunk_size=300, mesh=mesh)
    for i, leaf in enumerate(f.params):
        out[f"R{R}_cond_{i}"] = np.asarray(leaf)
    out[f"R{R}_cond_final"] = f.final_nll
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    rng = np.random.default_rng(5)
    n = 1003
    Y = rng.standard_normal((n, 2)).astype(np.float32)
    w = rng.uniform(0.5, 3.0, n).astype(np.float32)
    Xc = rng.standard_normal((n, 2))
    Yc = (Xc @ np.array([[1.5, -0.5], [0.3, 0.8]]).T + rng.standard_normal((n, 2))).astype(
        np.float32)
    path = str(tmp_path_factory.mktemp("mesh_fit") / "inputs.npz")
    np.savez(path, Y=Y, w=w, Yc=Yc, Xc=Xc)
    scaler, cscaler = DataScaler.fit(Y), DataScaler.fit(Yc)
    rcfg = RM.MCTMConfig(J=2, degree=5)

    def leaves(p):
        return tuple(np.asarray(x) for x in p)

    return dict(
        path=path, Y=Y, w=w, Yc=Yc, Xc=Xc, low=np.asarray(scaler.low),
        high=np.asarray(scaler.high), clow=np.asarray(cscaler.low),
        chigh=np.asarray(cscaler.high),
        p0=leaves(RM.init_params(jax.random.PRNGKey(1), rcfg)),
        p1=leaves(RM.init_params(jax.random.PRNGKey(2), rcfg)),
        cp0=leaves(RCo.init_cparams(jax.random.PRNGKey(4),
                                    RCo.CMCTMConfig(J=2, n_features=2, degree=5))),
    )


@pytest.fixture(scope="module")
def both(tmp_path_factory, inputs):
    path = str(tmp_path_factory.mktemp("mesh_fit_ref") / "ref.npz")
    script = REFERENCE.replace("sys.argv[2]", repr(inputs["path"]))
    inp = {k: v for k, v in inputs.items() if k != "path"}
    ref, port = run_reference_and_worlds(script, path, fit_all, inp)
    return ref, port, inputs


@pytest.fixture(scope="module")
def single(both):
    """The port's single-device fits on the same inputs (world 1)."""
    return fit_all(DataMesh(device="cpu"), {k: v for k, v in both[2].items() if k != "path"})


@pytest.mark.parametrize("R", WORLDS)
def test_evaluators_match_reference(both, R):
    ref, port, _ = both
    got = port[R][0]
    assert got["nll"] == pytest.approx(float(ref[f"R{R}_nll"]), rel=1e-6)
    assert got["nll_folds"] == 1
    assert got["eps"] == pytest.approx(float(ref[f"R{R}_eps"]), rel=1e-5)
    assert got["drift"] == pytest.approx(float(ref[f"R{R}_drift"]), rel=1e-6)
    assert got["bs"] == int(ref[f"R{R}_bs"]) and got["bs"] % (3 * R) == 0


def _check_fit(got, ref_losses, theta, lam, final, meth):
    th, la = got[f"{meth}_params"]
    if meth == "lbfgs":
        np.testing.assert_allclose(got["lbfgs_losses"][:5], ref_losses[:5], rtol=1e-5)
        assert abs(got["lbfgs_final"] - final) <= 1e-4 * abs(final)
        return
    np.testing.assert_allclose(th, theta, rtol=0, atol=1e-4)
    np.testing.assert_allclose(la, lam, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[f"{meth}_losses"], ref_losses, rtol=1e-4)
    assert got[f"{meth}_final"] == pytest.approx(final, rel=1e-5)


@pytest.mark.parametrize("R", WORLDS)
@pytest.mark.parametrize("meth", ["adam", "lbfgs", "minibatch"])
def test_fit_matches_reference_and_single_device(both, single, R, meth):
    ref, port, _ = both
    ranks = port[R]
    got = ranks[0]
    _check_fit(got, ref[f"R{R}_{meth}_losses"], ref[f"R{R}_{meth}_theta"],
               ref[f"R{R}_{meth}_lam"], float(ref[f"R{R}_{meth}_final"]), meth)
    _check_fit(got, single[f"{meth}_losses"], *single[f"{meth}_params"],
               single[f"{meth}_final"], meth)
    for other in ranks[1:]:  # every rank applied the same updates
        np.testing.assert_array_equal(other[f"{meth}_losses"], got[f"{meth}_losses"])
        for a, b in zip(other[f"{meth}_params"], got[f"{meth}_params"]):
            np.testing.assert_array_equal(a, b)
    # one fold a step (lbfgs: a sweep), and one for the final NLL
    steps = len(got[f"{meth}_losses"])
    want = (got["lbfgs_sweeps"]["vg"] + got["lbfgs_sweeps"]["hvp"] if meth == "lbfgs"
            else steps) + 1
    assert got[f"{meth}_folds"] == want


@pytest.mark.parametrize("R", WORLDS)
def test_fit_cmctm_on_the_mesh_matches_reference(both, R):
    ref, port, _ = both
    got = port[R][0]
    for i, leaf in enumerate(got["cond"]):
        np.testing.assert_allclose(leaf, ref[f"R{R}_cond_{i}"], rtol=0, atol=5e-4)
    assert got["cond_final"] == pytest.approx(float(ref[f"R{R}_cond_final"]), rel=1e-5)
    for other in port[R][1:]:
        for a, b in zip(other["cond"], got["cond"]):
            np.testing.assert_array_equal(a, b)


def test_world_one_fits_are_the_single_device_fits(both, single):
    """A world of 1 folds nothing: the same bits as a fit without a mesh."""
    inp = both[2]
    c = cfg()
    tscaler = TDataScaler(low=inp["low"], high=inp["high"])
    p0 = TM.params_from_numpy(*inp["p0"], device="cpu")
    for meth, steps in (("adam", 20), ("lbfgs", 10)):
        f = TF.fit_mctm_streaming(c, tscaler, inp["Y"], inp["w"], init=p0, steps=steps,
                                  method=meth, chunk_size=300, device="cpu")
        np.testing.assert_array_equal(f.losses, single[f"{meth}_losses"])
        assert f.final_nll == single[f"{meth}_final"]


@pytest.mark.parametrize("R", WORLDS)
def test_fit_mctm_takes_the_mesh(both, R):
    """``fit_mctm(mesh=)`` fits on the mesh: at world 2 within the adam
    limits of the reference's ``fit_mctm(mesh=)``, at every world the bits
    of ``fit_mctm_streaming(mesh=)``, the same on every rank."""
    ref, port, _ = both
    got = port[R][0]
    losses, params, final = got["fit_mctm"]
    if R == 2:
        _check_fit({"adam_params": params, "adam_losses": losses, "adam_final": final},
                   ref["R2_fit_mctm_losses"], ref["R2_fit_mctm_theta"], ref["R2_fit_mctm_lam"],
                   float(ref["R2_fit_mctm_final"]), "adam")
    np.testing.assert_array_equal(losses, got["adam_losses"])
    for a, b in zip(params, got["adam_params"]):
        np.testing.assert_array_equal(a, b)
    for other in port[R][1:]:
        np.testing.assert_array_equal(other["fit_mctm"][0], losses)


@pytest.mark.parametrize("R", WORLDS)
def test_drift_window_nll_takes_the_axis(both, R):
    ref, port, _ = both
    got = port[R][0]
    assert got["drift_axis"] == got["drift"]
    assert got["drift_axis"] == pytest.approx(float(ref[f"R{R}_drift"]), rel=1e-6)
    assert got["drift_bad_axis"] == "raised"


def test_world_one_fit_mctm_is_the_plain_fit(both, single):
    """``fit_mctm(mesh=)`` at world 1 gives the bits of the fit without a mesh."""
    inp = both[2]
    tscaler = TDataScaler(low=inp["low"], high=inp["high"])
    p0 = TM.params_from_numpy(*inp["p0"], device="cpu")
    f = TM.fit_mctm(cfg(), tscaler, inp["Y"], inp["w"], init=p0, steps=20, method="adam",
                    chunk_size=300, device="cpu")
    losses, params, final = single["fit_mctm"]
    np.testing.assert_array_equal(f.losses, losses)
    for a, b in zip(TM.params_to_numpy(f.params), params):
        np.testing.assert_array_equal(a, b)
    assert f.final_nll == final
