"""End-to-end serving driver: DGP stream → coreset → fit → serve → refresh —
the port of ``repro.launch.serve_mctm``, on one device.

``PYTHONPATH=src python -m repro_torch.launch.serve_mctm --smoke [--device cpu]``

  1. A DGP stream is consumed chunk by chunk into ``MergeReduceCoreset``
     (the first half of the stream seeds the initial model).
  2. Streamed L-BFGS fit on the maintained coreset
     (``core.mctm_fit.fit_mctm_streaming``) → the engine's version 0.
  3. ``DensityServeEngine`` builds its bucket ladder (one CUDA graph per
     kind and bucket on the card) and serves mixed open-loop traffic
     (``log_density`` + conditional ``sample``).
  4. A third of the way through the traffic the rest of the stream
     arrives; a background refit on the refreshed coreset
     (``engine.start_background_refit``: its own stream, publish after its
     event) publishes atomically while queries are in flight.

Prints a latency/throughput/consistency summary and exits nonzero if any
query was dropped, answered by a version other than the one it records, or
the steady state captured again. The record (``run``) holds the captures in
warmup and after it, p50/p99 latency per kind, queries/s, the refit's
build, fit and publish times and the largest log-density error against
``mctm.log_density`` of each answer's recorded version.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dgp", default="normal_mixture")
    ap.add_argument("--n", type=int, default=200_000,
                    help="total stream length (first half seeds the model)")
    ap.add_argument("--k", type=int, default=1000, help="coreset size")
    ap.add_argument("--degree", type=int, default=6)
    ap.add_argument("--steps", type=int, default=200, help="fit iterations")
    ap.add_argument("--chunk", type=int, default=16_384,
                    help="stream chunk size (also the fit chunk)")
    ap.add_argument("--queries", type=int, default=4096,
                    help="total queries of mixed traffic")
    ap.add_argument("--sample-frac", type=float, default=0.25,
                    help="fraction of traffic that is conditional-sample")
    ap.add_argument("--max-batch", type=int, default=256)
    ap.add_argument("--min-bucket", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny end-to-end run (seconds)")
    args = ap.parse_args(argv)
    if args.smoke:
        args.n = min(args.n, 20_000)
        args.k = min(args.k, 400)
        args.steps = min(args.steps, 60)
        args.chunk = min(args.chunk, 4096)
        args.queries = min(args.queries, 1024)
        args.max_batch = min(args.max_batch, 64)
    return args


# log-density answers against mctm.log_density of their recorded version:
# the same kernels on the same rows in another batch shape (f32 reassociation)
LOG_DENSITY_ATOL = 1e-4


def _gen(*parts: int) -> torch.Generator:
    return torch.Generator().manual_seed(int(np.random.SeedSequence(parts).generate_state(1)[0]))


def run(args) -> dict:
    from repro_torch.core import mctm as M
    from repro_torch.core.bernstein import DataScaler
    from repro_torch.core.mctm_fit import fit_mctm_streaming
    from repro_torch.core.streaming import MergeReduceCoreset
    from repro_torch.data.dgp import generate
    from repro_torch.device import resolve_device
    from repro_torch.serve.density import DensityServeEngine

    dev = resolve_device(args.device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    rng = np.random.default_rng(args.seed)
    cfg = M.MCTMConfig(J=2, degree=args.degree)
    Y = generate(args.dgp, args.n, seed=args.seed).astype(np.float32)
    scaler = DataScaler.fit(Y)  # full-range scaler, shared by every fit
    half = args.n // 2

    # ---- 1+2: stream the first half into the coreset, fit, version 0
    t0 = time.perf_counter()
    stream = MergeReduceCoreset(cfg, scaler, args.k, args.seed, chunk_size=args.chunk,
                                device=dev)
    for s in range(0, half, args.chunk):
        stream.push(Y[s:s + args.chunk])
    ws = stream.result()
    fit = fit_mctm_streaming(cfg, scaler, ws.Y, weights=np.asarray(ws.weights, np.float32),
                             generator=_gen(args.seed, 1), steps=args.steps, method="lbfgs",
                             chunk_size=args.chunk, device=dev)
    sync()
    boot_s = time.perf_counter() - t0
    print(f"[serve_mctm] boot: {stream.n_seen} rows streamed → k={ws.size} coreset → "
          f"lbfgs fit in {boot_s:.1f}s", flush=True)

    # ---- 3: serve mixed open-loop traffic
    engine = DensityServeEngine(cfg, fit.params, scaler, max_batch=args.max_batch,
                                min_bucket=args.min_bucket, sample_seed=args.seed, device=dev)
    t0 = time.perf_counter()
    captured = engine.warmup()
    warmup_s = time.perf_counter() - t0
    warm_compiles = engine.compile_count
    print(f"[serve_mctm] warmup: {captured} executables over buckets {engine.buckets} in "
          f"{warmup_s:.2f}s", flush=True)

    n_sample = int(args.queries * args.sample_frac)
    n_logd = args.queries - n_sample
    qY = Y[rng.integers(0, args.n, size=max(n_logd, 1))]
    refit_thread = None
    refit_at = args.queries // 3
    submitted = 0
    all_reqs = []
    si = li = 0
    serve_t0 = time.perf_counter()
    while (submitted < args.queries or any(engine.queues.values())
           # keep traffic flowing until the refit's publish is served live:
           # the point is a hot swap with queries in flight
           or (refit_thread is not None and engine.version < 1)):
        # open-loop arrivals: a burst per tick, mixed kinds
        burst = min(args.max_batch // 2, max(args.queries - submitted, 4))
        for _ in range(burst):
            if (si + li) % 4 == 3 and (si < n_sample or li >= n_logd):
                all_reqs += engine.submit_sample(1, y_obs=Y[si % args.n], n_obs=1, seeds=[si])
                si += 1
            else:
                all_reqs += engine.submit_log_density(qY[li % len(qY)][None])
                li += 1
            submitted += 1
        if refit_thread is None and submitted >= refit_at:
            # ---- 4: the rest of the stream arrives → background refit + publish
            for s in range(half, args.n, args.chunk):
                stream.push(Y[s:s + args.chunk])
            ws2 = stream.result()
            refit_thread = engine.start_background_refit(
                scaler, coreset=(ws2.Y, np.asarray(ws2.weights, np.float32)),
                generator=_gen(args.seed, 2), steps=args.steps, method="lbfgs",
                chunk_size=args.chunk)
        engine.step()
    if refit_thread is not None:
        refit_thread.join()
    serve_s = time.perf_counter() - serve_t0

    # ---- consistency: each log-density answer against its version's model
    versions = sorted({r.version for r in all_reqs})
    params = {0: fit.params}
    if engine.version >= 1:
        params[engine.version] = engine.current_slot().params
    logd = [r for r in all_reqs if r.kind == "log_density" and r.done]
    err = 0.0
    mixed = 0
    rows = np.stack([r.y for r in logd]) if logd else np.zeros((0, cfg.J), np.float32)
    refs = {}
    with torch.no_grad():
        for v, p in params.items():
            refs[v] = M.log_density(cfg, p, scaler, torch.as_tensor(rows, device=dev)).cpu()
    for i, r in enumerate(logd):
        d = {v: abs(r.result - float(refs[v][i])) for v in refs}
        err = max(err, d.get(r.version, np.inf))
        if d.get(r.version, np.inf) > LOG_DENSITY_ATOL or min(d, key=d.get) != r.version:
            mixed += 1
    lat = {kind: np.asarray([r.latency_s for r in all_reqs if r.kind == kind and r.done])
           for kind in ("log_density", "sample")}
    stall = [e["visible_s"] - e["published_s"] for e in engine.swap_events if e["visible_s"]]
    refit = engine.refit_log[-1] if engine.refit_log else {}
    rec = {
        "device": str(dev),
        "queries": len(all_reqs),
        "dropped": sum(1 for r in all_reqs if not r.done),
        "mixed_version_answers": mixed,
        "log_density_max_err": err,
        "versions_served": versions,
        "captures_warmup": warm_compiles,
        "captures_after_warmup": engine.compile_count - warm_compiles,
        "qps": len(all_reqs) / max(serve_s, 1e-9),
        "serve_s": serve_s,
        "warmup_s": warmup_s,
        "boot_s": boot_s,
        "p50_ms": {k: float(np.percentile(v, 50) * 1e3) for k, v in lat.items() if v.size},
        "p99_ms": {k: float(np.percentile(v, 99) * 1e3) for k, v in lat.items() if v.size},
        "swap_stall_ms": float(max(stall) * 1e3) if stall else 0.0,
        "refit": {k: refit[k] for k in ("build_s", "fit_s", "publish_s", "k") if k in refit},
        "replayed_launches": dict(engine.replayed_launches),
        "final_version": engine.version,
        "stats": engine.stats(),
    }
    print(f"[serve_mctm] served {rec['queries']} queries in {serve_s:.2f}s "
          f"({rec['qps']:.0f} QPS)  p50 {rec['p50_ms']} ms  p99 {rec['p99_ms']} ms", flush=True)
    print(f"[serve_mctm] hot swap: versions {versions} served, publish→visible "
          f"{rec['swap_stall_ms']:.2f}ms, dropped={rec['dropped']}, mixed={mixed}, "
          f"captures after warmup={rec['captures_after_warmup']}, refit {rec['refit']}",
          flush=True)
    return rec


def main(argv=None):
    rec = run(parse_args(argv))
    ok = (rec["dropped"] == 0 and rec["captures_after_warmup"] == 0
          and rec["mixed_version_answers"] == 0 and rec["final_version"] >= 1
          # the refit's publish was served LIVE: traffic straddled the swap
          and set(rec["versions_served"]) >= {0, 1})
    if not ok:
        print("[serve_mctm] FAILED consistency checks", flush=True)
        sys.exit(1)
    return rec


if __name__ == "__main__":
    main()
