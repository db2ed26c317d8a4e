"""Resumable scoring sweeps in the port (``ScoringEngine.score(sweep_ckpt=,
resume=)``): a sweep interrupted mid-scan and resumed from its chunk-cursor
checkpoint is bit-identical to the uninterrupted sweep, for the reference's
four ``METHOD_KWARGS`` (every pass strategy); the generator the plans are
drawn from ends where the uninterrupted call leaves it; the checkpoint is
read only with ``resume=True``; and the port's resumed result, on the
reference's own plans, agrees with the reference's resumed result within the
parity limits of ``tests/test_torch_scoring.py`` (ROADMAP Queue C 2: ridge
scores rtol 1e-5, l2 forms 5e-3, hull points ≥ 90% shared)."""
import tempfile

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import mctm as RM  # noqa: E402
from repro.core import scoring as RS  # noqa: E402
from repro.core.bernstein import DataScaler  # noqa: E402
from repro.ft.config import ft_overrides as r_overrides  # noqa: E402
from repro.ft.config import get_ft_config as r_config  # noqa: E402
from repro.ft.failure import FailureSimulator as RSim  # noqa: E402
from repro.ft.failure import InjectedFailure as RInjected  # noqa: E402
from repro_torch.core import bernstein as TB  # noqa: E402
from repro_torch.core import mctm as TM  # noqa: E402
from repro_torch.core import scoring as TS  # noqa: E402
from repro_torch.ft import FailureSimulator, InjectedFailure, get_ft_config  # noqa: E402
from repro_torch.ft.config import ft_overrides  # noqa: E402

N = 503


def _setup(n=N, seed=0):
    rng = np.random.default_rng(seed)
    Y = rng.random((n, 2)).astype(np.float32)
    scaler = DataScaler.fit(Y)
    return Y, scaler, TB.DataScaler(low=scaler.low, high=scaler.high)


# the reference's METHOD_KWARGS (tests/test_scoring_resume.py): l2-hull adds
# the extremes scan; the sketched pair runs the one-pass CountSketch path
METHOD_KWARGS = {
    "l2-only": {},
    "l2-hull": dict(hull_k=8),
    "ridge-lss": dict(sketch_size=128, ridge_reg=0.5),
    "root-l2": dict(sketch_size=128),
}
RTOL = {"l2-only": 5e-3, "l2-hull": 5e-3, "ridge-lss": 1e-5, "root-l2": 5e-3}


def _engine(tscaler):
    return TS.ScoringEngine(TM.MCTMConfig(J=2, degree=5), tscaler, chunk_size=64, device="cpu")


def _interrupt_until_done(score, crashes=(2, 5)):
    """Drive ``score(resume=True)`` to completion across injected mid-scan
    crashes (sweep 1's chunks 2 and 5)."""
    ft = get_ft_config()
    sim = FailureSimulator()
    for c in crashes:
        sim.inject("scoring", c)
    ft.simulator = sim
    try:
        interrupts = 0
        while True:
            try:
                return score(), interrupts
            except InjectedFailure:
                interrupts += 1
    finally:
        ft.simulator = None


def _same(a, b):
    np.testing.assert_array_equal(a.scores, b.scores)
    np.testing.assert_array_equal(a.leverage, b.leverage)
    np.testing.assert_array_equal(a.gram, b.gram)
    if a.hull_rows is not None or b.hull_rows is not None:
        np.testing.assert_array_equal(a.hull_rows, b.hull_rows)


@pytest.mark.parametrize("method", sorted(METHOD_KWARGS))
def test_single_host_resume_bit_identical(method):
    """Crashed twice, resumed from the cursor: the uninterrupted sweep's
    bits, and the plans' generator left where the uninterrupted call leaves
    it (its state at entry restored before the plans are drawn again)."""
    Y, _, tscaler = _setup()
    engine = _engine(tscaler)
    kwargs = dict(METHOD_KWARGS[method], method=method,
                  weights=np.linspace(0.5, 1.5, N).astype(np.float32))
    g_ref = torch.Generator().manual_seed(7)
    ref = engine.score(Y, generator=g_ref, **kwargs)
    g = torch.Generator().manual_seed(7)
    with tempfile.TemporaryDirectory() as d, ft_overrides(sweep_ckpt_every_chunks=2):
        got, interrupts = _interrupt_until_done(
            lambda: engine.score(Y, generator=g, sweep_ckpt=d, resume=True, **kwargs))
    assert interrupts == 2
    _same(ref, got)
    assert torch.equal(g.get_state(), g_ref.get_state())


def test_crash_in_sweep_two_resumes_from_its_cursor():
    """Two-pass: a crash in sweep 2 (chunk 12 of 8 + 8) resumes sweep 2 from
    its own cursor with the net redrawn from the entry state."""
    Y, _, tscaler = _setup()
    engine = _engine(tscaler)
    kw = dict(method="l2-hull", hull_k=8)
    ref = engine.score(Y, generator=torch.Generator().manual_seed(3), **kw)
    g = torch.Generator().manual_seed(3)
    with tempfile.TemporaryDirectory() as d, ft_overrides(sweep_ckpt_every_chunks=3):
        got, interrupts = _interrupt_until_done(
            lambda: engine.score(Y, generator=g, sweep_ckpt=d, resume=True, **kw), (12,))
    assert interrupts == 1
    _same(ref, got)


def test_sweep_checkpoint_unread_without_resume_flag():
    """A populated sweep_ckpt dir is only consulted when resume=True —
    otherwise the sweep restarts from chunk 0 (and still matches)."""
    Y, _, tscaler = _setup(n=257)
    engine = _engine(tscaler)
    ref = engine.score(Y, method="l2-only")
    with tempfile.TemporaryDirectory() as d, ft_overrides(sweep_ckpt_every_chunks=1):
        ft = get_ft_config()
        ft.simulator = FailureSimulator().inject("scoring", 2)
        try:
            with pytest.raises(InjectedFailure):
                engine.score(Y, method="l2-only", sweep_ckpt=d)
        finally:
            ft.simulator = None
        mgr = TS._SweepCheckpoints(d).mgr1
        assert mgr.latest_step() == 2
        got = engine.score(Y, method="l2-only", sweep_ckpt=d)
        assert mgr.latest_step() == 5  # rescanned from chunk 0, saved every chunk
    np.testing.assert_array_equal(ref.scores, got.scores)


def _reference_resumed(Y, scaler, kwargs, d):
    """The reference's crashed-and-resumed sweep (its own test's loop)."""
    engine = RS.ScoringEngine(RM.MCTMConfig(J=2, degree=5), scaler, chunk_size=64)
    ft = r_config()
    ft.simulator = RSim().inject("scoring", 2).inject("scoring", 5)
    try:
        while True:
            try:
                return engine.score(jnp.asarray(Y), sweep_ckpt=d, resume=True, **kwargs)
            except RInjected:
                pass
    finally:
        ft.simulator = None


@pytest.mark.parametrize("method", sorted(METHOD_KWARGS))
def test_resumed_port_matches_resumed_reference(method):
    """Both packages crash at the same chunks and resume; the port runs on
    the reference's CountSketch plan and hull normal draws."""
    Y, scaler, tscaler = _setup()
    w = np.linspace(0.5, 1.5, N).astype(np.float32)
    key, hull_key = jax.random.PRNGKey(3), jax.random.PRNGKey(7)
    base = dict(METHOD_KWARGS[method], method=method)
    rkw = dict(base, weights=jnp.asarray(w))
    tkw = dict(base, weights=w)
    if "sketch_size" in base:
        rkw["key"] = key
        plan = RS.OnePassSketched(base["sketch_size"]).begin(N, 12, key)
        tkw["plan"] = (np.asarray(plan[0]), np.asarray(plan[1]))
    if "hull_k" in base:
        rkw["hull_key"] = hull_key
        tkw["hull_normals"] = np.asarray(jax.random.normal(hull_key, (32, 6), jnp.float32))
    with tempfile.TemporaryDirectory() as d, r_overrides(sweep_ckpt_every_chunks=2):
        ref = _reference_resumed(Y, scaler, rkw, d)
    with tempfile.TemporaryDirectory() as d, ft_overrides(sweep_ckpt_every_chunks=2):
        got, interrupts = _interrupt_until_done(
            lambda: _engine(tscaler).score(Y, sweep_ckpt=d, resume=True, **tkw))
    assert interrupts == 2
    np.testing.assert_allclose(got.scores, np.asarray(ref.scores), rtol=RTOL[method])
    if ref.hull_points is not None:
        common = np.intersect1d(got.hull_points, ref.hull_points).size
        assert common >= 0.9 * ref.hull_points.size
