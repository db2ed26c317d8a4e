"""End-to-end driver of the paper's experiment on one device: DGP → coreset
→ weighted MCTM fit → streamed full-data (1±ε) NLL validation. The port of
``repro.launch.train_mctm``, single device, without mesh, fault tolerance
or checkpoints.

``PYTHONPATH=src python -m repro_torch.launch.train_mctm --reduced``

Stages (every data-sized computation on the device):
  1. DGP sample (paper §E.1.1 generators) + full-data scaler.
  2. Full-data reference fit (``--ref-method``, adam; basis streamed
     microbatch by microbatch) and its strict-η full-data NLL.
  3. Per k: ``build_coreset`` (``--strategy two-pass`` exact Gram, or
     ``one-pass`` with ``--sketch-size``, 0 → 4·(Jd)²), the weighted coreset
     fit (``--fit-method``, adam), the full-data NLL at the coreset fit, the
     measured ε̂ (``coreset_epsilon``) and the likelihood-ratio check
     1−ε̂−δ ≤ ratio ≤ (1+ε̂)/(1−ε̂)+δ with optimization slack δ.

Prints one line per stage and returns the record (``per_k`` fields as the
JAX driver's); ``--out`` also writes it as JSON. Exits nonzero when a ratio
leaves its band.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from repro_torch.core import mctm as M
from repro_torch.core.bernstein import DataScaler
from repro_torch.core.coreset import build_coreset
from repro_torch.core.mctm_fit import (
    coreset_epsilon,
    fit_mctm_streaming,
    likelihood_ratio,
    streamed_nll,
)
from repro_torch.data.dgp import generate
from repro_torch.device import resolve_device


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dgp", default="normal_mixture")
    ap.add_argument("--n", type=int, default=250_001)
    ap.add_argument("--ks", default=None,
                    help="coreset sizes (default by scale: 500,1000,2000,4000 "
                    "full / 500,2000 --reduced / 300,600 --smoke)")
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--fit-method", default="adam", choices=("adam", "lbfgs", "minibatch"),
                    help="coreset-fit mode (only adam is ported)")
    ap.add_argument("--ref-method", default="adam", choices=("adam", "lbfgs", "minibatch"),
                    help="full-data reference-fit mode (only adam is ported)")
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
    ap.add_argument("--log-every", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("--out", default=None, help="also write the record here (JSON)")
    args = ap.parse_args(argv)
    if args.reduced:
        args.steps = min(args.steps, 250)
    if args.smoke:
        args.n = min(args.n, 30_001)
        args.steps = min(args.steps, 120)
        args.chunk = min(args.chunk, 4096)
    if args.ks is None:
        args.ks = "300,600" if args.smoke else "500,2000" if args.reduced else "500,1000,2000,4000"
    return args


def _seeded(*parts: int) -> torch.Generator:
    """A CPU generator per stage, seeded from (seed, stage, k)."""
    return torch.Generator().manual_seed(int(np.random.SeedSequence(parts).generate_state(1)[0]))


def run(args) -> dict:
    dev = resolve_device(args.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    ks = [int(k) for k in args.ks.split(",")]
    cfg = M.MCTMConfig(J=2, degree=args.degree)
    D = cfg.J * cfg.d
    sketch = args.sketch_size
    if args.strategy == "one-pass" and sketch == 0:
        sketch = 4 * D * D
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"[train_mctm] dgp={args.dgp} n={args.n} device={name} "
          f"strategy={args.strategy} sketch={sketch} steps={args.steps} "
          f"fit={args.fit_method} ref={args.ref_method}", flush=True)
    Y = generate(args.dgp, args.n, seed=args.seed).astype(np.float32)
    scaler = DataScaler.fit(Y)

    sync()
    t0 = time.perf_counter()
    full = fit_mctm_streaming(
        cfg, scaler, Y, steps=args.steps, lr=args.lr, generator=_seeded(args.seed, 0),
        method=args.ref_method, chunk_size=args.chunk, log_every=args.log_every, device=dev,
    )
    sync()
    full_fit_s = time.perf_counter() - t0
    nll_full_at_full = streamed_nll(cfg, scaler, full.params, Y, chunk=args.chunk, eta=1e-9,
                                    device=dev)
    print(f"[train_mctm] full fit {full_fit_s:.2f}s  NLL/pt {nll_full_at_full / args.n:.4f}",
          flush=True)

    per_k = []
    for k in ks:
        sync()
        t0 = time.perf_counter()
        cs = build_coreset(
            cfg, scaler, Y, k, "l2-hull", generator=_seeded(args.seed, 1, k),
            alpha=args.alpha, sketch_size=sketch, chunk_size=args.chunk, device=dev,
        )
        sync()
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cs_w = np.asarray(cs.weights, np.float32)
        fit = fit_mctm_streaming(
            cfg, scaler, Y[cs.indices], weights=cs_w, steps=args.steps, lr=args.lr,
            generator=_seeded(args.seed, 2, k), method=args.fit_method,
            chunk_size=args.chunk, log_every=args.log_every, device=dev,
        )
        sync()
        fit_s = time.perf_counter() - t0
        nll_full_at_cs = streamed_nll(cfg, scaler, fit.params, Y, chunk=args.chunk, eta=1e-9,
                                      device=dev)
        eps = coreset_epsilon(
            cfg, scaler, Y, Y[cs.indices], cs_w, [fit.params, full.params],
            chunk=args.chunk, eta=1e-9, full_nlls=[nll_full_at_cs, nll_full_at_full],
            device=dev,
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
        print(f"[train_mctm] k={k:6d}  build {build_s:6.3f}s fit {fit_s:6.3f}s  "
              f"eps={eps:.4f}  ratio={ratio:.4f} in ({lo:.3f}, {hi:.3f}) "
              f"{'OK' if within else 'VIOLATION'}  speedup {speedup:.1f}x", flush=True)

    rec = {
        "dgp": args.dgp,
        "n": args.n,
        "J": cfg.J,
        "degree": args.degree,
        "steps": args.steps,
        "fit_method": args.fit_method,
        "ref_method": args.ref_method,
        "lr": args.lr,
        "chunk": args.chunk,
        "alpha": args.alpha,
        "strategy": args.strategy,
        "sketch_size": sketch,
        "device": name,
        "smoke": bool(args.smoke),
        "reduced": bool(args.reduced),
        "opt_slack": args.opt_slack,
        "full_fit_s": full_fit_s,
        "full_nll_per_point": nll_full_at_full / args.n,
        "per_k": per_k,
        "all_within_band": all(r["within_band"] for r in per_k),
        "coreset_beats_full_fit": all(r["total_s"] < full_fit_s for r in per_k),
    }
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"[train_mctm] wrote {args.out}", flush=True)
    return rec


def main(argv=None) -> dict:
    rec = run(parse_args(argv))
    if not rec["all_within_band"]:
        sys.exit(1)
    return rec


if __name__ == "__main__":
    main()
