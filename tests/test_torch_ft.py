"""The port's fault-tolerance layer (``repro_torch.ft``, ``train.loop``)
against the reference's: the planner, straggler, simulator and supervisor
cases of ``test_ft.py`` and ``test_ft_recovery.py``, each run on both
packages with the same inputs and held to the same outcome (plans, event
lists, the backoff sequence); a kernel that fails to build or launch is
never retried; ``train_loop`` raises ``NonFiniteError`` before the poisoned
state is checkpointed."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.ft as RF  # noqa: E402
import repro_torch.ft as TF  # noqa: E402
from repro.ft import config as RC  # noqa: E402
from repro_torch.ft import config as TC  # noqa: E402

PKGS = {"ref": (RF, RC), "port": (TF, TC)}


@pytest.mark.parametrize("args,n_alive", [
    (dict(model_parallel=16, base_data_parallel=16, n_pods=2, base_global_batch=256), 512),
    (dict(model_parallel=16, base_data_parallel=16, n_pods=2, base_global_batch=256), 300),
    (dict(model_parallel=16, base_data_parallel=16, n_pods=2), 17 * 16),
    (dict(model_parallel=2, base_data_parallel=4, base_global_batch=64), 6),
    (dict(model_parallel=1, base_data_parallel=1), 1),
])
def test_elastic_planner_matches_reference(args, n_alive):
    ref = RF.ElasticPlanner(**args).plan(n_alive)
    got = TF.ElasticPlanner(**args).plan(n_alive)
    assert got == TF.MeshPlan(*(getattr(ref, f) for f in ("shape", "axes", "global_batch",
                                                           "lr_scale", "devices_used")))
    assert got.n_devices == ref.n_devices


def test_elastic_planner_insufficient():
    for pkg in (RF, TF):
        with pytest.raises(RuntimeError):
            pkg.ElasticPlanner(model_parallel=16, base_data_parallel=16).plan(8)


def test_straggler_policy():
    ms = np.array([10.0, 250.0, 99.0, 101.0])
    got = TF.StragglerPolicy(deadline_ms=100).decide(ms)
    assert got.tolist() == RF.StragglerPolicy(deadline_ms=100).decide(ms).tolist()
    assert got.tolist() == [False, True, False, True]


def test_mesh_from_plan_on_one_host():
    plan = TF.ElasticPlanner(model_parallel=1, base_data_parallel=1).plan(1)
    mesh = TF.mesh_from_plan(plan, devices=[torch.device("cpu")])
    assert mesh.shape == plan.shape and mesh.ravel()[0] == torch.device("cpu")
    with pytest.raises(RuntimeError):
        TF.mesh_from_plan(TF.ElasticPlanner(model_parallel=2, base_data_parallel=1).plan(2),
                          devices=[torch.device("cpu")])


# ---------------------------------------------------------------- simulator


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_simulator_once_fires_single_time_across_retries(pkg):
    ft, _ = PKGS[pkg]
    sim = ft.FailureSimulator().inject("scoring", 3)
    with pytest.raises(ft.InjectedFailure):
        sim.maybe_fail(3, phase="scoring")
    sim.maybe_fail(3, phase="scoring")
    sim.maybe_fail(3, phase="fit")
    assert sim.log == [{"phase": "scoring", "step": 3, "mode": "once", "count": 1}]


def test_simulator_every_refires_and_log_persists():
    logs = []
    for ft in (RF, TF):
        sim = ft.FailureSimulator({1}).inject("fit", 2, mode="every")
        for step, phase in ((1, "x"), (2, "fit"), (2, "fit"), (1, "y"), (2, "fit")):
            try:
                sim.maybe_fail(step, phase=phase)
            except ft.InjectedFailure:
                pass
        logs.append((sim.log, sim.failures, sorted(sim.fail_at)))
    assert logs[0] == logs[1]
    assert [e["count"] for e in logs[1][0] if e["step"] == 2] == [1, 2, 3]


# --------------------------------------------------------------- supervisor


def _run(pkg, attempt_fn, overrides, **sup_kw):
    """A supervisor run on one package: (result or the raised error, the
    attempt contexts seen, the sleeps, the events)."""
    ft, cfg = PKGS[pkg]
    slept, seen = [], []

    def attempt(ctx):
        seen.append((ctx.attempt, ctx.resume, ctx.lr_scale, ctx.batch_scale,
                     None if ctx.plan is None else ctx.plan.shape))
        return attempt_fn(ft, ctx)

    sup = ft.RunSupervisor(sleep=slept.append, **sup_kw)
    with cfg.ft_overrides(**overrides):
        try:
            out = sup.run(attempt)
        except Exception as exc:  # noqa: BLE001 — compared across packages
            out = (type(exc).__name__, str(exc))
    return out, seen, slept, sup.events


def _transient(ft, ctx):
    if ctx.attempt < 2:
        raise RuntimeError("transient")
    return "done"


def _nonfinite(ft, ctx):
    if ctx.attempt < 2:
        raise ft.NonFiniteError(ctx.attempt, loss=float("nan"))
    return "ok"


def _node_lost(ft, ctx):
    if ctx.attempt == 0:
        raise RuntimeError("node lost")
    return ctx.mesh


def _always(ft, ctx):
    raise ft.InjectedFailure("injected node failure at step 0 (fit)")


@pytest.mark.parametrize("scenario", ["retries", "nonfinite", "replan", "exhausted"])
def test_supervisor_matches_reference(scenario):
    """The same attempt on both packages: the same result or diagnostic,
    contexts (attempt, resume, LR and batch scales, plan), backoff sleeps
    and event list."""
    fn, overrides, kw = {
        "retries": (_transient, dict(max_retries=3, backoff_base_s=0.05, backoff_factor=2.0), {}),
        "nonfinite": (_nonfinite, dict(max_retries=3, lr_backoff_factor=0.5,
                                       backoff_base_s=0.0), {}),
        "replan": (_node_lost, dict(max_retries=2, backoff_base_s=0.0, rescale_lr=True),
                   {"devices_fn": lambda: 6, "remesh": lambda plan: ("mesh", plan.shape)}),
        "exhausted": (_always, dict(max_retries=2, backoff_base_s=0.01, backoff_factor=3.0,
                                    backoff_max_s=0.02), {}),
    }[scenario]

    def planner(pkg):
        if scenario == "replan":
            return {"planner": PKGS[pkg][0].ElasticPlanner(
                model_parallel=2, base_data_parallel=4, base_global_batch=64)}
        if scenario == "nonfinite":
            return {"planner": PKGS[pkg][0].ElasticPlanner(model_parallel=1,
                                                           base_data_parallel=8),
                    "devices_fn": lambda: 8}
        return {}

    ref = _run("ref", fn, overrides, label="t", **kw, **planner("ref"))
    got = _run("port", fn, overrides, label="t", **kw, **planner("port"))
    assert got == ref
    if scenario == "retries":
        assert got[0] == "done" and got[2] == [0.05, 0.1]
    elif scenario == "nonfinite":
        assert [s[2] for s in got[1]] == [1.0, 0.5, 0.25] and all(s[4] is None for s in got[1])
    elif scenario == "replan":
        assert got[0] == ("mesh", (3, 2)) and got[1][-1][3] == 48 / 64
    else:
        assert got[0][0] == "RuntimeError" and "retry budget exhausted after 3 attempts" in got[0][1]
        assert got[2] == [0.01, 0.02]


def test_supervisor_diagnostic_includes_injection_log():
    msgs = []
    for pkg, (ft, cfg) in sorted(PKGS.items()):
        sim = ft.FailureSimulator().inject("fit", 0, mode="every")
        conf = cfg.get_ft_config()
        with cfg.ft_overrides(max_retries=1, backoff_base_s=0.0):
            conf.simulator = sim
            try:
                with pytest.raises(RuntimeError) as ei:
                    ft.RunSupervisor(label="crash").run(
                        lambda ctx: sim.maybe_fail(0, phase="fit"))
            finally:
                conf.simulator = None
        assert isinstance(ei.value.__cause__, ft.InjectedFailure)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]
    assert "retry budget exhausted after 2 attempts" in msgs[1] and "'fit'" in msgs[1]


def _kernel_build_fails():
    from repro_torch.kernels import _lib

    raise _lib.KernelError("nvcc failed:\nsweep.cu: error")


def _kernel_launch_fails():
    from repro_torch.kernels import _lib

    _lib.check(700, "repro_extremes")


@pytest.mark.parametrize("exc", [ValueError("bad"), TypeError("bad"), NotImplementedError("bad"),
                                 "build", "launch"])
def test_non_retryable_propagates_immediately(exc):
    """Programming errors, and a kernel that does not build or launch, are
    raised on the first attempt: no retry hides them behind a 'retry budget
    exhausted' message."""
    from repro_torch.kernels import _lib

    calls = []

    def attempt(ctx):
        calls.append(ctx.attempt)
        if exc == "build":
            _kernel_build_fails()
        elif exc == "launch":
            _kernel_launch_fails()
        raise exc

    want = _lib.KernelError if isinstance(exc, str) else type(exc)
    with pytest.raises(want) as ei:
        TF.RunSupervisor().run(attempt)
    assert calls == [0] and "retry budget" not in str(ei.value)
    assert issubclass(_lib.KernelError, RuntimeError)


# ----------------------------------------------------- lr backoff machinery


def test_scale_updates_halves_updates_same_state_structure():
    from repro.optim import adamw as radamw
    from repro.optim import scale_updates as rscale
    from repro_torch.optim import adamw, scale_updates

    opt = adamw(1e-2)
    assert scale_updates(opt, 1.0) is opt
    g = np.full((3,), 2.0, np.float32)
    s0 = opt.init([torch.ones(3)])
    u_full, s1 = opt.update([torch.from_numpy(g)], s0, [torch.ones(3)], 0)
    u_half, s1h = scale_updates(opt, 0.5).update([torch.from_numpy(g)], s0, [torch.ones(3)], 0)
    assert torch.equal(u_half[0], 0.5 * u_full[0])
    assert s1.keys() == s1h.keys()
    for k in s1:
        assert all(torch.equal(a, b) for a, b in zip(s1[k], s1h[k]))
    rs0 = radamw(1e-2).init({"w": jnp.ones(3)})
    ru, _ = rscale(radamw(1e-2), 0.5).update({"w": jnp.asarray(g)}, rs0, {"w": jnp.ones(3)},
                                             jnp.asarray(0))
    np.testing.assert_allclose(u_half[0].numpy(), np.asarray(ru["w"]), rtol=1e-6)


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_train_loop_raises_nonfinite_before_checkpointing(tmp_path, pkg):
    """Step 2's loss is NaN: ``NonFiniteError(step=2)`` before the step-3
    state is saved, on both packages (the port's state as tensors)."""
    if pkg == "ref":
        from repro.checkpoint import CheckpointManager
        from repro.train.loop import train_loop

        state = {"step": jnp.asarray(0, jnp.int32), "x": jnp.zeros(())}
        scalar = jnp.asarray
    else:
        from repro_torch.checkpoint import CheckpointManager
        from repro_torch.train.loop import train_loop

        state = {"step": torch.tensor(0, dtype=torch.int32), "x": torch.zeros(())}
        scalar = torch.tensor
    ft, cfg = PKGS[pkg]
    mgr = CheckpointManager(str(tmp_path))

    def step_fn(state, batch):
        i = int(state["step"])
        new = {"step": state["step"] + 1, "x": state["x"]}
        return new, {"loss": scalar(np.nan if i == 2 else 1.0), "grad_norm": scalar(0.0)}

    with cfg.ft_overrides(nonfinite_rollback=True, nonfinite_check_every=1):
        with pytest.raises(ft.NonFiniteError) as ei:
            train_loop(step_fn, state, lambda i: {}, 8, mgr=mgr, ckpt_every=1)
    assert ei.value.step == 2
    assert mgr.latest_step() == 2


def test_ft_config_fields_and_env_overrides_match(monkeypatch):
    import dataclasses

    assert [(f.name, f.default) for f in dataclasses.fields(TF.FTConfig)] == [
        (f.name, f.default) for f in dataclasses.fields(RF.FTConfig)]
    monkeypatch.setenv("REPRO_FT_MAX_RETRIES", "5")
    monkeypatch.setenv("REPRO_FT_NONFINITE_ROLLBACK", "off")
    monkeypatch.setenv("REPRO_FT_BACKOFF_BASE_S", "0.25")
    got = TC._env_overrides(TF.FTConfig())
    assert (got.max_retries, got.nonfinite_rollback, got.backoff_base_s) == (5, False, 0.25)
    assert dataclasses.asdict(got) == dataclasses.asdict(RC._env_overrides(RF.FTConfig()))
    with pytest.raises(TypeError):
        with TC.ft_overrides(no_such_field=1):
            pass
