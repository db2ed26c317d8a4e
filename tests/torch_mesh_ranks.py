"""Rank bodies of the port's mesh tests (``tests/test_torch_distributed_coreset.py``,
``tests/test_torch_mesh_fit.py``, ``tests/test_torch_mesh.py``): each runs on
every rank of a spawned gloo world (``repro_torch.distributed.run_world``)
and returns what the parent compares. Spawned ranks import this module, so
it imports the port alone, never the JAX package: a rank starts in about a
second."""
import copy
import multiprocessing
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.core import coreset as TC
from repro_torch.core import distributed_coreset as TD
from repro_torch.core import mctm as TM
from repro_torch.core import scoring as TS
from repro_torch.core.bernstein import DataScaler
from repro_torch.data.pipeline import CoresetSelector
from repro_torch.distributed import run_world

N, CHUNK, HULL_K, SK = 1003, 64, 20, 256
WORLDS = (2, 4)
SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")

# A spawned rank imports this module in a process of its own: pin it to one
# intra-op thread, as the test files pin theirs (tests/torch_threads.py), so
# the ranks of a world and the suite's workers do not contend for the CPUs.
if multiprocessing.parent_process() is not None:
    torch.set_num_threads(1)


def run_reference_and_worlds(script: str, path: str, body, inp, worlds=WORLDS):
    """The JAX side (``script`` writing ``path``, 4 fake CPU devices) in a
    subprocess while the port's worlds run, each in its own thread; returns
    (reference arrays, {R: per-rank results})."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=SRC)
    proc = subprocess.Popen([sys.executable, "-c", script, path], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        with ThreadPoolExecutor(len(worlds)) as pool:
            futs = {R: pool.submit(run_world, body, R, backend="gloo", devices=["cpu"] * R,
                                   args=(inp,), timeout_s=300) for R in worlds}
            port = {R: f.result() for R, f in futs.items()}
        _, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-3000:]
    return dict(np.load(path)), port


def cfg(degree=5):
    return TM.MCTMConfig(J=2, degree=degree)


def lookup(X, P):
    """Row i's (X, P) by the index in column 0 (two P rows a point): both
    packages score the same feature bits."""
    Xt, Pt = torch.tensor(X), torch.tensor(P)

    def featurize(Yc):
        idx = Yc[:, 0].long()
        return Xt[idx], Pt[(2 * idx[:, None] + torch.arange(2)).reshape(-1)]

    return featurize


def score_all(mesh, inp) -> dict:
    """Every scoring check of one world, run by each rank."""
    Y = inp["Y"]
    scaler = DataScaler.fit(Y)
    out = {}
    leng = TD.DistributedScoringEngine(featurize=lookup(*inp["look"]), rows_per_point=2,
                                       mesh=mesh, chunk_size=CHUNK)
    ids = np.arange(N, dtype=np.float32)[:, None]
    for tag, kw in (("two", {}), ("one", {"sketch_size": SK, "plan": inp["plan"]})):
        r = leng.score(ids, method="l2-hull", hull_k=HULL_K, hull_normals=inp["normals5"], **kw)
        out[f"look_{tag}"], out[f"look_{tag}_hull"] = r.scores, r.hull_rows
        out[f"look_{tag}_exact"] = TC.exact_hull_points(r, r.scores, HULL_K)
    eng = TD.DistributedScoringEngine(cfg(), scaler, mesh=mesh, chunk_size=CHUNK)
    mesh.reset_census()
    r = eng.score(Y, method="l2-hull", hull_k=HULL_K, hull_normals=inp["normals5"])
    out["census_two"] = copy.deepcopy(mesh.census)
    out["two"], out["two_hull"] = r.scores, r.hull_rows
    out["two_exact"] = TC.exact_hull_points(r, r.scores, HULL_K)
    out["two_w"] = eng.score(Y, method="l2-only", weights=inp["w"]).scores
    mesh.reset_census()
    r = eng.score(Y, method="l2-hull", hull_k=HULL_K, hull_normals=inp["normals5"],
                  sketch_size=SK, plan=inp["plan"])
    out["census_one"] = copy.deepcopy(mesh.census)
    out["one"], out["one_hull"] = r.scores, r.hull_rows
    out["one_exact"] = TC.exact_hull_points(r, r.scores, HULL_K)
    out["one_q8_w"] = eng.score(Y, method="l2-only", weights=inp["w"], plan=inp["plan_q8"],
                                strategy=TS.OnePassSketched(SK, proj_size=8)).scores
    out["tps"] = eng.score(Y, method="l2-hull", hull_k=HULL_K, hull_normals=inp["normals5"],
                           strategy=TS.TwoPassSketched(SK), plan=inp["plan"]).scores
    scaler6 = DataScaler.fit(inp["Y6"])
    r = TD.DistributedScoringEngine(cfg(6), scaler6, mesh=mesh, chunk_size=CHUNK,
                                    gram_dtype="float64").score(
        inp["Y6"], method="l2-hull", hull_k=HULL_K, hull_normals=inp["normals6"])
    out["f64"], out["f64_hull"] = r.scores, r.hull_rows
    # the build's scoring on the reference's plans (its draw is applied by
    # the parent), and a whole build from a generator: the same bits on every rank
    out["build_res"] = eng.score(Y, method="l2-hull", hull_k=HULL_K,
                                 hull_normals=inp["normals_build"])
    cs = TD.distributed_build_coreset(cfg(), scaler, Y, 100, mesh=mesh, chunk_size=CHUNK,
                                      generator=torch.Generator().manual_seed(7))
    out["gen_idx"], out["gen_w"] = cs.indices, cs.weights
    out["sel_idx"], out["sel_w"] = select(mesh, inp)
    # primitives
    argmax = {}
    rng = np.random.default_rng(11)
    dirs = rng.standard_normal((12, 5)).astype(np.float32)
    for n in (163, 9, 5, 1):
        Pn = rng.standard_normal((n, 5)).astype(np.float32)
        argmax[n] = (TD.distributed_direction_argmax(Pn, dirs, mesh),
                     np.argmax(Pn @ dirs.T, axis=0))
    out["argmax"] = argmax
    try:
        TD.distributed_direction_argmax(np.zeros((0, 5), np.float32), dirs, mesh)
        out["empty_raises"] = False
    except ValueError:
        out["empty_raises"] = True
    out["gram"] = TD.distributed_gram(inp["X"], mesh).numpy()
    out["lev"] = TD.distributed_leverage(inp["X"], mesh).numpy()
    out["stats"] = [t.numpy() for t in TD.distributed_scoring_stats(inp["X"], inp["P"], mesh)]
    # staged rows: the same scores and hull rows as the whole input
    feng = TD.DistributedScoringEngine(featurize=lambda F: (F, F), mesh=mesh, chunk_size=CHUNK,
                                       rows_per_point=1)
    F = inp["ex"]
    staged = feng.stage_rows((F[lo:lo + 100] for lo in range(0, N, 100)), N, 6)
    a = feng.score(F, method="l2-hull", hull_k=4, generator=torch.Generator().manual_seed(1))
    b = feng.score(staged, method="l2-hull", hull_k=4,
                   generator=torch.Generator().manual_seed(1))
    lo, hi, _, _ = TD.rank_rows(mesh, N, CHUNK)
    out["staged"] = (a.scores, b.scores, a.hull_rows, b.hull_rows, int(staged.rows.shape[0]),
                     hi - lo)
    try:
        feng.stage_rows(iter([np.zeros((3, 6), np.float32)]), 5, 6)
        out["short_raises"] = False
    except ValueError:
        out["short_raises"] = True
    return out


def double(E):
    return E * 2.0


def select(mesh, inp):
    """``CoresetSelector`` (on ``mesh``, or single-host) with the reference's
    hull normals and sample draw."""
    sel = CoresetSelector(double, chunk_size=CHUNK, mesh=mesh,
                          device=None if mesh is not None else "cpu")
    got = sel.select(inp["ex"], 64, plan={"hull_normals": inp["normals_sel"],
                                          "draw": inp["sel_draw"]})
    return got.indices, got.weights


# ---------------------------------------------------------------------------
# the fit layer and the evaluators (tests/test_torch_mesh_fit.py)
# ---------------------------------------------------------------------------


def fit_all(mesh, inp) -> dict:
    """Every fit and evaluator check of one world, run by each rank."""
    from repro_torch.core import conditional as TCo
    from repro_torch.core import mctm_fit as TF
    from repro_torch.core import streaming as TSt

    Y, w = inp["Y"], inp["w"]
    c = cfg()
    scaler = DataScaler(low=inp["low"], high=inp["high"])
    p0 = TM.params_from_numpy(*inp["p0"], device="cpu")
    p1 = TM.params_from_numpy(*inp["p1"], device="cpu")
    out = {}
    mesh.reset_census()
    out["nll"] = TF.streamed_nll(c, scaler, p0, Y, w, chunk=100, mesh=mesh)
    out["nll_folds"] = mesh.calls("fold")
    out["eps"] = TF.coreset_epsilon(c, scaler, Y, Y[:200], w[:200] * 5, [p0, p1], chunk=100,
                                    mesh=mesh)
    out["drift"] = TSt.drift_window_nll(c, scaler, p0, Y, w, chunk=100, mesh=mesh)
    out["bs"] = TF.resolve_batch_size(1000, 3, mesh)
    for meth, steps in (("adam", 20), ("lbfgs", 10), ("minibatch", 10)):
        mesh.reset_census()
        f = TF.fit_mctm_streaming(c, scaler, Y, w, init=p0, steps=steps, method=meth,
                                  chunk_size=300, batch_size=256, mesh=mesh)
        out[f"{meth}_folds"] = mesh.calls("fold")
        out[f"{meth}_losses"] = f.losses
        out[f"{meth}_params"] = TM.params_to_numpy(f.params)
        out[f"{meth}_final"] = f.final_nll
        if meth == "lbfgs":
            out["lbfgs_sweeps"] = dict(TF.LAST_LBFGS_SWEEPS)
    # the reference's fit_mctm(mesh=) and drift_window_nll(axis=)
    f = TM.fit_mctm(c, scaler, Y, w, init=p0, steps=20, method="adam", chunk_size=300,
                    mesh=mesh)
    out["fit_mctm"] = (f.losses, TM.params_to_numpy(f.params), f.final_nll)
    out["drift_axis"] = TSt.drift_window_nll(c, scaler, p0, Y, w, chunk=100, mesh=mesh,
                                             axis="data")
    try:
        TSt.drift_window_nll(c, scaler, p0, Y, w, chunk=100, mesh=mesh, axis="model")
        out["drift_bad_axis"] = "accepted"
    except ValueError:
        out["drift_bad_axis"] = "raised"
    ccfg = TCo.CMCTMConfig(J=2, n_features=2, degree=5)
    cscaler = DataScaler(low=inp["clow"], high=inp["chigh"])
    f = TCo.fit_cmctm(ccfg, cscaler, inp["Yc"], inp["Xc"], weights=w, steps=20,
                      chunk_size=300, init=TCo.cparams_from_numpy(*inp["cp0"], device="cpu"),
                      mesh=mesh)
    out["cond"] = TCo.cparams_to_numpy(f.params)
    out["cond_final"] = f.final_nll
    return out


# ---------------------------------------------------------------------------
# the mesh itself, resumable sweeps and rank-0 checkpoints (tests/test_torch_mesh.py)
# ---------------------------------------------------------------------------


def mesh_all(mesh, scratch) -> dict:
    """The collectives, the host exchange, a crashed segmented sweep and a
    crashed fit resumed on the mesh."""
    import os

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import mctm_fit as TF
    from repro_torch.distributed import host_gather, kv_allreduce
    from repro_torch.ft import FailureSimulator, get_ft_config

    r = mesh.rank
    out = {}
    parts = [torch.full((3,), 0.1 * (r + 1)), None, torch.tensor([1e-17 * (r + 1)], dtype=torch.float64),
             torch.arange(4, dtype=torch.int64) * (r + 1)]
    mesh.reset_census()
    out["fold"] = [None if t is None else t.numpy() for t in mesh.fold(parts)]
    out["fold_calls"] = mesh.calls("fold")
    out["rows"] = mesh.gather_rows(torch.arange(r + 1, dtype=torch.float32) + 10 * r, 3,
                                   3 + 1).numpy()
    out["host"] = host_gather(np.arange(r + 1), mesh)
    out["kv"] = kv_allreduce({"a": np.ones(2) * (r + 1), "b": np.arange(3)}, mesh)
    out["share"] = mesh.share(f"from {r}")
    # a segmented sweep crashed in segment 2, resumed to the uninterrupted bits
    rng = np.random.default_rng(0)
    Y = rng.random((N, 2)).astype(np.float32)
    scaler = DataScaler.fit(Y)
    eng = TD.DistributedScoringEngine(cfg(), scaler, mesh=mesh, chunk_size=CHUNK)
    ft = get_ft_config()
    ft.sweep_ckpt_every_chunks = 2
    for tag, kw in (("two", {}), ("one", {"sketch_size": SK})):
        def score(resume, sub, **extra):
            return eng.score(Y, method="l2-hull", hull_k=HULL_K,
                             generator=torch.Generator().manual_seed(3),
                             sweep_ckpt=os.path.join(scratch, sub), resume=resume, **kw,
                             **extra)

        straight = score(False, f"{tag}_straight")
        ft.simulator = sim = FailureSimulator().inject("scoring", 4)
        try:
            score(False, f"{tag}_crash")
            crashed = False
        except RuntimeError:
            crashed = True
        finally:
            ft.simulator = None
        resumed = score(True, f"{tag}_crash")
        out[f"seg_{tag}"] = (crashed, [e["step"] for e in sim.log],
                             np.array_equal(straight.scores, resumed.scores),
                             np.array_equal(straight.hull_rows, resumed.hull_rows),
                             np.array_equal(straight.gram, resumed.gram))
    try:
        TD.DistributedScoringEngine(cfg(), scaler, mesh=mesh, chunk_size=CHUNK // 2).score(
            Y, method="l2-only", sweep_ckpt=os.path.join(scratch, "two_crash"), resume=True)
        out["layout_raises"] = False
    except ValueError:
        out["layout_raises"] = True
    ft.sweep_ckpt_every_chunks = 4
    # an adam fit crashed at step 5, rolled back to rank 0's step-4 save
    p0 = TM.init_params(cfg(), generator=torch.Generator().manual_seed(0), device="cpu")
    common = dict(init=p0, steps=8, chunk_size=300, mesh=mesh)
    straight = TF.fit_mctm_streaming(cfg(), scaler, Y, **common)
    ft.simulator = sim = FailureSimulator().inject("fit", 5)
    try:
        mgr = CheckpointManager(os.path.join(scratch, "fit"), mesh=mesh)
        resumed = TF.fit_mctm_streaming(cfg(), scaler, Y, checkpoint=mgr, ckpt_every=4, **common)
    finally:
        ft.simulator = None
    out["fit_resume"] = ([e["step"] for e in sim.log], np.array_equal(straight.losses[-3:],
                         resumed.losses[-3:]), all(
        np.array_equal(a, b) for a, b in zip(TM.params_to_numpy(straight.params),
                                             TM.params_to_numpy(resumed.params))),
        sorted(os.listdir(os.path.join(scratch, "fit"))))
    return out


def dead_peer(mesh, timeout_ms=None):
    """A kv exchange whose peer never arrives: rank 1 sleeps past the
    deadline, rank 0's ``kv_allreduce`` must raise ``RuntimeError``. The
    deadline is the ``ft`` config's, or the call's ``timeout_ms``."""
    import time

    from repro_torch.distributed import kv_allreduce

    if mesh.rank == 1:
        time.sleep(3.5)
        return "slept"
    t0 = time.monotonic()
    try:
        if timeout_ms is None:
            kv_allreduce([np.ones(1)], mesh)
        else:
            kv_allreduce([np.ones(1)], mesh, timeout_ms=timeout_ms)
    except RuntimeError:
        return ("raised", time.monotonic() - t0)
    return "no error"


# ---------------------------------------------------------------------------
# the peer-death drill (tests/test_multiprocess.py's kill-one-worker drill):
# rank 1 dies mid-training; rank 0's next kv_allreduce raises (the dead-peer
# signal), its RunSupervisor retries, restores its last checkpoint and
# finishes degraded on all the rows alone
# ---------------------------------------------------------------------------

DRILL_STEPS, DRILL_KILL_AT, DRILL_LR = 12, 7, 0.05


def drill_data():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((64, 4)).astype(np.float32)
    y = (X @ np.array([1.0, -2.0, 0.5, 3.0], np.float32)).astype(np.float32)
    return X, y


def drill_grad_loss(X, y, w, rows):
    """Partial gradient and loss normalized by the GLOBAL row count, so the
    cross-rank sum is the full-batch gradient and loss."""
    r = X[rows] @ w - y[rows]
    return (X[rows].T @ r) * (2.0 / len(X)), np.float32(r @ r / len(X))


def drill_reference():
    X, y = drill_data()
    w = np.zeros(4, np.float32)
    for _ in range(DRILL_STEPS):
        g, loss = drill_grad_loss(X, y, w, np.arange(64))
        w = w - DRILL_LR * g
    return w, float(loss)


def peer_death_drill(mesh, ckpt_dir, kill_at=DRILL_KILL_AT):
    """Rank ``1`` exits with code 17 at step ``kill_at`` (``kill_at=None``:
    nobody dies); rank 0 returns its weights, loss and supervisor events."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed import kv_allreduce
    from repro_torch.ft import RunSupervisor
    from repro_torch.ft.config import ft_overrides

    X, y = drill_data()
    halves = np.array_split(np.arange(64), 2)
    mgr = CheckpointManager(os.path.join(ckpt_dir, f"rank{mesh.rank}"), keep=2)

    def attempt(ctx):
        w, start = np.zeros(4, np.float32), 0
        if ctx.resume:
            got = mgr.restore({"step": np.zeros((), np.int64), "w": w})
            w, start = np.asarray(got["w"]), int(got["step"])
        degraded = ctx.attempt > 0  # the survivor: its own rows and the peer's, no exchange
        loss = None
        for i in range(start, DRILL_STEPS):
            if mesh.rank == 1 and i == kill_at:
                os._exit(17)
            if degraded:
                g, loss = drill_grad_loss(X, y, w, np.arange(64))
            else:
                g, loss = kv_allreduce(drill_grad_loss(X, y, w, halves[mesh.rank]), mesh)
            w = w - DRILL_LR * np.asarray(g)
            if (i + 1) % 2 == 0:
                mgr.save(i + 1, {"step": np.asarray(i + 1, np.int64), "w": w})
        return w, float(loss)

    with ft_overrides(max_retries=2, backoff_base_s=0.0):
        sup = RunSupervisor(label="killworker", devices_fn=lambda: 2)
        w, loss = sup.run(attempt)
    return w, loss, list(sup.events)
