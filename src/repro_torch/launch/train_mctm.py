"""End-to-end driver of the paper's experiment on a data mesh: DGP → coreset
→ weighted MCTM fit → streamed full-data (1±ε) NLL validation. The port of
``repro.launch.train_mctm``.

``PYTHONPATH=src python -m repro_torch.launch.train_mctm --reduced``

Every stage runs on ``launch.stages.data_mesh()``, as the JAX driver's do:
the builds through ``distributed_build_coreset``, every fit and evaluator
with ``mesh=``. A plain launch is a world of 1 (no process group; the same
numbers as a single-device run). On a node, one rank per card over NCCL:
``torchrun --nproc-per-node=G -m repro_torch.launch.train_mctm``.
``--fake-devices N`` spawns N ranks on gloo from this process, on
``--device`` (each rank on the CPU, or all sharing the one card): the
counterpart of the JAX driver's re-exec onto N fake CPU devices. Rank 0
prints and writes the record.

Stages (every data-sized computation on the device):
  1. DGP sample (paper §E.1.1 generators) + full-data scaler.
  2. Full-data reference fit (``--ref-method``, by default the streaming
     ``lbfgs`` as in the JAX driver: the paper's quasi-Newton full-data
     baseline, early-stopping at ``--gtol``; basis streamed microbatch by
     microbatch) and its strict-η full-data NLL.
  3. Per k: ``distributed_build_coreset`` (``--strategy two-pass`` exact Gram, or
     ``one-pass`` with ``--sketch-size``, 0 → 4·(Jd)²), the weighted coreset
     fit (``--fit-method``, adam by default; ``minibatch`` draws
     ``--batch-size`` rows a step), the full-data NLL at the
     coreset fit, the measured ε̂ (``coreset_epsilon``) and the
     likelihood-ratio check 1−ε̂−δ ≤ ratio ≤ (1+ε̂)/(1−ε̂)+δ with
     optimization slack δ.

Fault tolerance, as the JAX driver's: ``--ckpt-dir`` / ``--ckpt-every``
checkpoint every fit (``full/``, ``k<k>/``) and ``--resume`` restarts them
from the latest save. ``--inject-failures [scoring,fit,checkpoint]`` is the
recovery drill: it crashes the build's first sweep at chunk 2, the first fit
at step steps//3 and the checkpoint save at step 2·ckpt-every, and recovers
through the fits' supervisors and an outer supervisor around each build that
resumes its sweep from the latest sweep checkpoint; the record gains ``ft``
(the injection log and the supervisor's events), and the run fails if no
injection fired.

Prints one line per stage and returns the record (``per_k`` fields as the
JAX driver's); ``--out`` also writes it as JSON. Exits nonzero when a ratio
leaves its band.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import mctm as M
from repro_torch.core.bernstein import DataScaler
from repro_torch.core.distributed_coreset import distributed_build_coreset
from repro_torch.core.mctm_fit import (
    coreset_epsilon,
    fit_mctm_streaming,
    likelihood_ratio,
    streamed_nll,
)
from repro_torch.data.dgp import generate
from repro_torch.distributed.mesh import run_world
from repro_torch.ft import ElasticPlanner, FailureSimulator, FTConfig, RunSupervisor
from repro_torch.ft.config import get_ft_config
from repro_torch.launch.stages import data_mesh


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dgp", default="normal_mixture")
    ap.add_argument("--n", type=int, default=250_001)
    ap.add_argument("--ks", default=None,
                    help="coreset sizes (default by scale: 500,1000,2000,4000 "
                    "full / 500,2000 --reduced / 300,600 --smoke)")
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--fit-method", default="adam", choices=("adam", "lbfgs", "minibatch"),
                    help="coreset-fit mode (core.mctm_fit method table)")
    ap.add_argument("--ref-method", default="lbfgs", choices=("adam", "lbfgs", "minibatch"),
                    help="full-data reference-fit mode (default: streaming lbfgs, the "
                    "paper's quasi-Newton baseline)")
    ap.add_argument("--batch-size", type=int, default=4096,
                    help="minibatch-mode rows sampled per step")
    ap.add_argument("--gtol", type=float, default=1e-5,
                    help="lbfgs-mode gradient-norm early stop (the objective is "
                    "mean-normalized, so this is scale-free)")
    ap.add_argument("--lr", type=float, default=5e-2)
    ap.add_argument("--degree", type=int, default=6)
    ap.add_argument("--alpha", type=float, default=0.8)
    ap.add_argument("--chunk", type=int, default=16_384)
    ap.add_argument("--strategy", default="two-pass", choices=("two-pass", "one-pass"))
    ap.add_argument("--sketch-size", type=int, default=0,
                    help="one-pass CountSketch rows (0 → 4·(Jd)² auto)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reduced", action="store_true", help="fewer steps / fewer k points")
    ap.add_argument("--smoke", action="store_true", help="tiny end-to-end run")
    ap.add_argument("--opt-slack", type=float, default=0.02,
                    help="likelihood-ratio tolerance for finite-step fits")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("--fake-devices", type=int, default=0, metavar="N",
                    help="spawn N ranks on gloo, all on --device (a mesh without torchrun)")
    ap.add_argument("--out", default=None, help="also write the record here (JSON)")
    ap.add_argument("--inject-failures", nargs="?", const="scoring,fit,checkpoint",
                    default=None, metavar="PHASES",
                    help="failure-injected recovery drill: crash mid-scoring / mid-fit / "
                    "mid-checkpoint (comma list of phases; bare flag = all three) and "
                    "recover through the ft supervisor and resumable sweeps")
    args = ap.parse_args(argv)
    if args.reduced:
        args.steps = min(args.steps, 250)
    if args.smoke:
        args.n = min(args.n, 30_001)
        args.steps = min(args.steps, 120)
        args.chunk = min(args.chunk, 4096)
        args.batch_size = min(args.batch_size, 1024)
    if args.ks is None:
        args.ks = "300,600" if args.smoke else "500,2000" if args.reduced else "500,1000,2000,4000"
    return args


def _seeded(*parts: int) -> torch.Generator:
    """A CPU generator per stage, seeded from (seed, stage, k)."""
    return torch.Generator().manual_seed(int(np.random.SeedSequence(parts).generate_state(1)[0]))


def run(args, mesh=None) -> dict:
    """The experiment on ``mesh`` (None → ``data_mesh()``)."""
    if mesh is None:
        mesh = data_mesh(device=args.device)
    dev = mesh.device

    def say(msg: str) -> None:
        if mesh.rank == 0:
            print(msg, flush=True)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    sim = sup = None
    if args.inject_failures:
        phases = [p.strip() for p in args.inject_failures.split(",") if p.strip()]
        if not args.ckpt_dir:
            args.ckpt_dir = mesh.share(tempfile.mkdtemp(prefix="ft_ckpt_")
                                       if mesh.rank == 0 else None)
        if not args.ckpt_every:
            args.ckpt_every = 20
        # several chunks so mid-scoring checkpoints exist to resume
        args.chunk = min(args.chunk, 4096)
        sim = FailureSimulator()
        if "scoring" in phases:
            sim.inject("scoring", 2)
        if "fit" in phases:
            sim.inject("fit", max(args.steps // 3, 1))
        if "checkpoint" in phases:
            sim.inject("checkpoint", 2 * args.ckpt_every)
        ft_cfg = get_ft_config()
        ft_cfg.simulator = sim
        ft_cfg.sweep_ckpt_every_chunks = 2
        # the build has no supervisor of its own: this one replays the sweep
        # from its latest checkpoint through resume=ctx.resume
        sup = RunSupervisor(label="train_mctm", mesh=mesh,
                            planner=ElasticPlanner(model_parallel=1,
                                                   base_data_parallel=mesh.world),
                            devices_fn=lambda: mesh.world, remesh=lambda plan: mesh)

    def mgr(tag):
        if not args.ckpt_dir:
            return None
        return CheckpointManager(os.path.join(args.ckpt_dir, tag), keep=2, mesh=mesh)

    ks = [int(k) for k in args.ks.split(",")]
    cfg = M.MCTMConfig(J=2, degree=args.degree)
    D = cfg.J * cfg.d
    sketch = args.sketch_size
    if args.strategy == "one-pass" and sketch == 0:
        sketch = 4 * D * D
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    say(f"[train_mctm] dgp={args.dgp} n={args.n} device={name} devices={mesh.world} "
        f"backend={mesh.backend or 'none'} strategy={args.strategy} sketch={sketch} "
        f"steps={args.steps} fit={args.fit_method} ref={args.ref_method}")
    Y = generate(args.dgp, args.n, seed=args.seed).astype(np.float32)
    scaler = DataScaler.fit(Y)

    sync()
    t0 = time.perf_counter()
    full = fit_mctm_streaming(
        cfg, scaler, Y, steps=args.steps, lr=args.lr, generator=_seeded(args.seed, 0),
        method=args.ref_method, batch_size=args.batch_size, gtol=args.gtol,
        chunk_size=args.chunk, checkpoint=mgr("full"), ckpt_every=args.ckpt_every,
        resume=args.resume, log_every=args.log_every, mesh=mesh,
    )
    sync()
    full_fit_s = time.perf_counter() - t0
    nll_full_at_full = streamed_nll(cfg, scaler, full.params, Y, chunk=args.chunk, eta=1e-9,
                                    mesh=mesh)
    say(f"[train_mctm] full fit {full_fit_s:.2f}s  NLL/pt {nll_full_at_full / args.n:.4f}")

    per_k = []
    for k in ks:
        sync()
        t0 = time.perf_counter()
        gen = _seeded(args.seed, 1, k)

        def build(ctx=None):
            return distributed_build_coreset(
                cfg, scaler, Y, k, "l2-hull", mesh=mesh, generator=gen, alpha=args.alpha,
                sketch_size=sketch, chunk_size=args.chunk,
                sweep_ckpt=(os.path.join(args.ckpt_dir, f"build_k{k}")
                            if args.inject_failures else None),
                resume=bool(ctx is not None and ctx.resume),
            )

        cs = sup.run(build) if sup is not None else build()
        sync()
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cs_w = np.asarray(cs.weights, np.float32)
        fit = fit_mctm_streaming(
            cfg, scaler, Y[cs.indices], weights=cs_w, steps=args.steps, lr=args.lr,
            generator=_seeded(args.seed, 2, k), method=args.fit_method,
            batch_size=args.batch_size, gtol=args.gtol,
            chunk_size=args.chunk, checkpoint=mgr(f"k{k}"), ckpt_every=args.ckpt_every,
            resume=args.resume, log_every=args.log_every, mesh=mesh,
        )
        sync()
        fit_s = time.perf_counter() - t0
        nll_full_at_cs = streamed_nll(cfg, scaler, fit.params, Y, chunk=args.chunk, eta=1e-9,
                                      mesh=mesh)
        eps = coreset_epsilon(
            cfg, scaler, Y, Y[cs.indices], cs_w, [fit.params, full.params],
            chunk=args.chunk, eta=1e-9, full_nlls=[nll_full_at_cs, nll_full_at_full],
            mesh=mesh,
        )
        ratio = likelihood_ratio(nll_full_at_cs, nll_full_at_full)
        lo = 1.0 - eps - args.opt_slack
        hi = (1.0 + eps) / max(1.0 - eps, 1e-6) + args.opt_slack
        within = lo <= ratio <= hi
        speedup = full_fit_s / max(build_s + fit_s, 1e-9)
        per_k.append({
            "k": k,
            "build_s": build_s,
            "fit_s": fit_s,
            "total_s": build_s + fit_s,
            "speedup_vs_full_fit": speedup,
            "eps_hat": eps,
            "ratio": ratio,
            "band": [lo, hi],
            "within_band": bool(within),
            "nll_full_at_cs_per_point": nll_full_at_cs / args.n,
        })
        say(f"[train_mctm] k={k:6d}  build {build_s:6.3f}s fit {fit_s:6.3f}s  "
            f"eps={eps:.4f}  ratio={ratio:.4f} in ({lo:.3f}, {hi:.3f}) "
            f"{'OK' if within else 'VIOLATION'}  speedup {speedup:.1f}x")

    rec = {
        "dgp": args.dgp,
        "n": args.n,
        "J": cfg.J,
        "degree": args.degree,
        "steps": args.steps,
        "fit_method": args.fit_method,
        "ref_method": args.ref_method,
        "batch_size": args.batch_size,
        "lr": args.lr,
        "chunk": args.chunk,
        "alpha": args.alpha,
        "strategy": args.strategy,
        "sketch_size": sketch,
        "device": name,
        "devices": mesh.world,
        "backend": mesh.backend,
        "smoke": bool(args.smoke),
        "reduced": bool(args.reduced),
        "opt_slack": args.opt_slack,
        "full_fit_s": full_fit_s,
        "full_nll_per_point": nll_full_at_full / args.n,
        "per_k": per_k,
        "all_within_band": all(r["within_band"] for r in per_k),
        "coreset_beats_full_fit": all(r["total_s"] < full_fit_s for r in per_k),
    }
    if sim is not None:
        rec["ft"] = {"injected": list(sim.log), "supervisor_events": list(sup.events)}
        say(f"[train_mctm] injected {len(sim.log)} failures ({args.inject_failures}); "
            "all recovered")
    if args.out and mesh.rank == 0:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
        say(f"[train_mctm] wrote {args.out}")
    return rec


def _rank_run(mesh, args) -> dict:
    return run(args, mesh)


def main(argv=None) -> dict:
    args = parse_args(argv)
    try:
        if args.fake_devices > 1:
            dev = torch.device(args.device or "cuda")
            if dev.type == "cuda":
                from repro_torch.kernels import _lib

                _lib.lib()  # built here once; the ranks load it
            if args.inject_failures and not args.ckpt_dir:
                args.ckpt_dir = tempfile.mkdtemp(prefix="ft_ckpt_")
            rec = run_world(_rank_run, args.fake_devices, backend="gloo",
                            devices=[dev] * args.fake_devices, args=(args,),
                            timeout_s=24 * 3600.0)[0]
        else:
            rec = run(args)
    finally:
        if args.inject_failures:
            cfg = get_ft_config()
            cfg.simulator = None
            cfg.sweep_ckpt_every_chunks = FTConfig.sweep_ckpt_every_chunks
    if not rec["all_within_band"]:
        sys.exit(1)
    if args.inject_failures and not rec.get("ft", {}).get("injected"):
        print("[train_mctm] --inject-failures requested but nothing fired", flush=True)
        sys.exit(1)
    return rec


if __name__ == "__main__":
    main()
