"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA H100: builds the kernels from this checkout's sources, holds each
kernel against its plain PyTorch version at the main path's shapes, drives
the Algorithm 1 path end to end through ``repro_torch.launch.train_mctm``
(two-pass, then one-pass), and checks that every kernel of the path ran.

    python3 chip_smoke.py

Phases (any failure exits nonzero):
  1. environment: card, power limit, torch/CUDA/nvcc versions, Triton, build time;
  2. each kernel vs its plain version on the card, with times from CUDA events;
  3. the path at n = 250,001 (normal_mixture, J = 2, degree 6, chunk 16,384,
     α = 0.8, k = 500 and 2000, adam 250 steps at lr 0.05 for the coreset
     and the full-data fits), both strategies; every ratio must lie in its
     band; plus the path's scores and fit held against the plain (CPU) path
     on a small input;
  4. launch census of the path's kernels.
The last line is ``{"ok": true, "device": {...}}``; the line before it the
card's name and power limit; before that the ``kernels`` JSON line.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12       # f32 outside the tensor cores, H100 SXM data sheet
MAIN_N = 250_001
CHUNK = 16_384
SKETCH = 784                 # 4·(J·d)² at J = 2, d = 7
KS = (500, 2000)


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def _run(cmd) -> str:
    try:
        out = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                             timeout=60)
        return out.stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"


# ---------------------------------------------------------------- phase 1


def phase_environment():
    import torch

    from repro_torch.kernels import _lib

    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    log(f"card: {smi}")
    log(f"torch {torch.__version__} CUDA {torch.version.cuda} python {sys.version.split()[0]}")
    log("nvcc: " + _run([_lib._nvcc(), "--version"]).splitlines()[-1])
    try:
        import triton  # noqa: F401  (probed, never used by the port)

        log(f"triton imports: {triton.__version__}")
    except ImportError as e:
        log(f"triton does not import: {e}")
    t0 = time.perf_counter()
    _lib.lib()
    log(f"kernel library ready in {time.perf_counter() - t0:.2f}s "
        f"(nvcc build {_lib.BUILD_SECONDS if _lib.BUILD_SECONDS is not None else 'cached'}s)")
    return smi.splitlines()[0] if smi else smi


# ---------------------------------------------------------------- phase 2


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    tb, tf = nbytes / H100_BYTES_PER_S * 1e3, flops / H100_F32_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def close(a, b, *, rtol: float, atol: float) -> bool:
    import torch

    return bool(torch.allclose(a.double(), b.double(), rtol=rtol, atol=atol))


def phase_kernels(dev):
    """Each kernel against its plain version at the main path's shapes."""
    import numpy as np
    import torch

    from repro_torch.core import mctm as M
    from repro_torch.core.bernstein import DataScaler
    from repro_torch.core.scoring import _mctm_featurize, directions_from_moments, sketch_plan
    from repro_torch.core.scoring import upfront_directions
    from repro_torch.data.dgp import generate
    from repro_torch.kernels.bernstein.ops import bernstein_featurize
    from repro_torch.kernels.bernstein.ref import bernstein_featurize_ref
    from repro_torch.kernels.extremes.ops import directional_extremes
    from repro_torch.kernels.extremes.ref import directional_extremes_ref
    from repro_torch.kernels.gram.ops import gram_matrix
    from repro_torch.kernels.gram.ref import gram_ref
    from repro_torch.kernels.sweep.ops import fused_sweep_update
    from repro_torch.kernels.sweep.ref import fused_sweep_ref

    cfg = M.MCTMConfig(J=2, degree=6)
    d, D = cfg.d, cfg.J * cfg.d
    Yn = generate("normal_mixture", MAIN_N, seed=0).astype(np.float32)
    scaler = DataScaler.fit(Yn)
    Y = torch.as_tensor(Yn, device=dev)
    bounds = scaler.bounds(torch.float32, dev)
    X, P = _mctm_featurize(cfg, scaler)(Y[:CHUNK])
    sw = torch.ones(CHUNK, device=dev)
    gen = torch.Generator().manual_seed(0)
    s1, s2 = P.sum(0), P.T @ P
    dirs = {k: torch.as_tensor(directions_from_moments(s1, s2, P.shape[0], k - int(0.8 * k),
                                                       generator=gen), device=dev)
            for k in KS}
    rows_all = []
    errs = []

    def row(name, source, replaces, err, ms, plain_ms, lib_ms, nbytes, flops):
        b, by = bound_ms(nbytes, flops)
        rows_all.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b, "bound_by": by, "library_ms": lib_ms,
        })
        log(f"kernel {name}: max_abs_err {err:.3e}  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
            f"library {lib_ms if lib_ms is None else f'{lib_ms:.4f}'} ms  bound {b:.4f} ms ({by})")

    # ---- bernstein: all n = 250,001 points at once (the dense featurize)
    A, Ap = bernstein_featurize(Y, bounds, cfg.degree)
    Ar, Apr = bernstein_featurize_ref(Y, bounds, cfg.degree)
    torch.cuda.synchronize()
    err = max(max_err(A, Ar), max_err(Ap, Apr))
    if not (close(A, Ar, rtol=0, atol=1e-6) and close(Ap, Apr, rtol=0, atol=1e-6)):
        errs.append(f"bernstein disagrees with its plain version: {err}")
    nv = MAIN_N * cfg.J
    row("bernstein", "src/repro_torch/csrc/bernstein.cu",
        "src/repro/kernels/bernstein/kernel.py:48", err,
        cuda_ms(lambda: bernstein_featurize(Y, bounds, cfg.degree)),
        cuda_ms(lambda: bernstein_featurize_ref(Y, bounds, cfg.degree)), None,
        nbytes=4 * nv + 4 * bounds.numel() + 2 * 4 * nv * d,
        flops=nv * (7 + 2 * cfg.degree + 2 * d + 2 * cfg.degree + 3 * d))

    # ---- gram: one (16,384, 14) chunk, √w = 1 as on the main path
    G = gram_matrix(X, sw)
    Gr = gram_ref(X, sw)
    torch.cuda.synchronize()
    err = max_err(G, Gr)
    if err > 1e-5 * float(Gr.abs().max()):
        errs.append(f"gram disagrees with its plain version: {err}")
    row("gram", "src/repro_torch/csrc/gram.cu", "src/repro/kernels/gram/kernel.py:30", err,
        cuda_ms(lambda: gram_matrix(X, sw)), cuda_ms(lambda: gram_ref(X, sw)),
        cuda_ms(lambda: torch.mm(X.T, X)),
        nbytes=4 * (CHUNK * D + CHUNK + D * D), flops=CHUNK * (D + D * (D + 1)))

    # ---- extremes: P (32,768, 7) against both nets, whole, ragged, and tied
    Ptie = P.clone()
    half = P.shape[0] // 2
    Ptie[half:] = P[:half]  # every extreme ties with its copy: the first must win
    ext_err = 0.0
    for k in KS:
        for Pc, nv_rows, tag in ((P, P.shape[0], "whole"), (P, P.shape[0] - 1001, "ragged"),
                                 (Ptie, Ptie.shape[0], "tied")):
            got = directional_extremes(Pc, dirs[k], nv_rows)
            ref = directional_extremes_ref(Pc, dirs[k], nv_rows)
            torch.cuda.synchronize()
            mism = int((got[1] != ref[1]).sum()) + int((got[3] != ref[3]).sum())
            e = max(max_err(got[0], ref[0]), max_err(got[2], ref[2]))
            ext_err = max(ext_err, e)
            log(f"  extremes m={dirs[k].shape[0]} {tag}: index mismatches {mism}, "
                f"max value err {e:.3e}")
            if mism or e > 1e-4:
                errs.append(f"extremes m={dirs[k].shape[0]} {tag} disagrees: {mism} indices, {e}")
            if tag == "tied" and (int(got[1].max()) >= half or int(got[3].max()) >= half):
                errs.append("extremes kept a later copy on an exact tie")
    dk = dirs[KS[-1]]
    m = dk.shape[0]

    def library_extremes():
        S = dk @ P.T
        return S.max(dim=1), S.min(dim=1)

    row("extremes", "src/repro_torch/csrc/extremes.cu",
        "src/repro/kernels/extremes/kernel.py:66", ext_err,
        cuda_ms(lambda: directional_extremes(P, dk)),
        cuda_ms(lambda: directional_extremes_ref(P, dk)), cuda_ms(library_extremes),
        nbytes=4 * (P.numel() + dk.numel() + 4 * m), flops=2 * m * P.shape[0] * d)

    # ---- sweep: sketch 784, with and without Ω, with and without moments
    rows_p, signs_p = sketch_plan(CHUNK, SKETCH, generator=gen, device=dev)
    SX0 = torch.zeros((SKETCH, D), device=dev)
    omega = torch.randn((D, 8), generator=gen).to(dev) / np.sqrt(8)
    mom0 = (torch.zeros(d, device=dev), torch.zeros((d, d), device=dev))
    up = torch.as_tensor(upfront_directions(d, KS[-1] - int(0.8 * KS[-1]), generator=gen),
                         device=dev)
    sweep_err = 0.0
    for om in (None, omega):
        for mom in (None, mom0):
            got = fused_sweep_update(SX0, X, P, sw, rows_p, signs_p, dirs=up, omega=om,
                                     n_valid=CHUNK - 77, moments=mom)
            ref = fused_sweep_ref(SX0, X, P, sw, rows_p, signs_p, dirs=up, omega=om,
                                  n_valid=CHUNK - 77, moments=mom)
            torch.cuda.synchronize()
            tag = f"omega={'on' if om is not None else 'off'} moments={'on' if mom else 'off'}"
            ok = close(got[0], ref[0], rtol=1e-6, atol=1e-6) and close(got[1], ref[1],
                                                                      rtol=1e-6, atol=1e-6)
            mism = int((got[2][1] != ref[2][1]).sum()) + int((got[2][3] != ref[2][3]).sum())
            e = max(max_err(got[0], ref[0]), max_err(got[1], ref[1]),
                    max_err(got[2][0], ref[2][0]), max_err(got[2][2], ref[2][2]))
            if mom is not None:
                # moments against the plain version in float64: the kernel's
                # compensated sums sit far below the f32 plain sum's own error
                r64 = fused_sweep_ref(SX0.double(), X.double(), P.double(), sw.double(), rows_p,
                                      signs_p.double(), moments=tuple(t.double() for t in mom),
                                      want_z=False)[3]
                for g, rr in zip(got[3], r64):
                    ok = ok and close(g, rr, rtol=1e-6, atol=1e-4)
                    e = max(e, max_err(g, rr))
            sweep_err = max(sweep_err, e)
            log(f"  sweep {tag}: index mismatches {mism}, max err {e:.3e}")
            if not ok or mism:
                errs.append(f"sweep {tag} disagrees: {mism} indices, {e}")
    mu = up.shape[0]
    row("sweep", "src/repro_torch/csrc/sweep.cu", "src/repro/kernels/sweep/kernel.py:136",
        sweep_err,
        cuda_ms(lambda: fused_sweep_update(SX0, X, P, sw, rows_p, signs_p, dirs=up)),
        cuda_ms(lambda: fused_sweep_ref(SX0, X, P, sw, rows_p, signs_p, dirs=up)), None,
        nbytes=4 * (2 * CHUNK * D + P.numel() + 3 * CHUNK + up.numel() + 2 * SKETCH * D
                    + 4 * mu),
        flops=CHUNK * 2 * D + 2 * mu * P.shape[0] * d)
    if errs:
        fail("; ".join(errs))
    return rows_all


# ---------------------------------------------------------------- phase 3


def phase_path(dev):
    """The Algorithm 1 path, both strategies; returns launches per kernel."""
    from repro_torch.kernels.bernstein import ops as bern
    from repro_torch.kernels.extremes import ops as ext
    from repro_torch.kernels.gram import ops as gram
    from repro_torch.kernels.sweep import ops as sweep
    from repro_torch.launch import train_mctm

    mods = {"bernstein": bern, "gram": gram, "extremes": ext, "sweep": sweep}
    need = {"two-pass": ("bernstein", "gram", "extremes"), "one-pass": ("bernstein", "sweep")}
    total = dict.fromkeys(mods, 0)
    for strategy in ("two-pass", "one-pass"):
        argv = [
            "--device", "cuda", "--dgp", "normal_mixture", "--n", str(MAIN_N), "--seed", "0",
            "--degree", "6", "--chunk", str(CHUNK), "--alpha", "0.8",
            "--ks", ",".join(map(str, KS)), "--steps", "250", "--lr", "0.05",
            "--fit-method", "adam", "--ref-method", "adam", "--strategy", strategy,
        ]
        if strategy == "one-pass":
            argv += ["--sketch-size", str(SKETCH)]
        for mod in mods.values():
            mod.LAUNCHES = 0
        rec = train_mctm.main(argv)  # exits nonzero when a ratio leaves its band
        counts = {k: mod.LAUNCHES for k, mod in mods.items()}
        log(f"path {strategy}: full fit {rec['full_fit_s']:.3f}s  "
            f"NLL/pt {rec['full_nll_per_point']:.5f}  launches {counts}")
        for r in rec["per_k"]:
            log(f"  {strategy} k={r['k']}: build_s {r['build_s']:.4f} fit_s {r['fit_s']:.4f} "
                f"eps_hat {r['eps_hat']:.5f} ratio {r['ratio']:.5f} "
                f"band [{r['band'][0]:.4f}, {r['band'][1]:.4f}] within_band {r['within_band']}")
        for name in need[strategy]:
            if counts[name] == 0:
                fail(f"{name} was not launched on the {strategy} path")
        for k in total:
            total[k] += counts[k]
    return total


def phase_small_agreement(dev):
    """The card's path against the plain (CPU) path on a small input: scores
    of both strategies and a fit on one coreset."""
    import numpy as np
    import torch

    from repro_torch.core import mctm as M
    from repro_torch.core.bernstein import DataScaler
    from repro_torch.core.mctm_fit import fit_mctm_streaming
    from repro_torch.core.scoring import ScoringEngine
    from repro_torch.data.dgp import generate

    cfg = M.MCTMConfig(J=2, degree=6)
    Yn = generate("normal_mixture", 3001, seed=1).astype(np.float32)
    scaler = DataScaler.fit(Yn)
    # ridge-lss (G + λI, well conditioned) to 1e-4; l2-hull to 5e-3: the
    # pseudo-inverse of the degree-6 Gram turns f32 sums taken in another
    # order into up to ~3e-3 relative leverage (tests/test_torch_scoring.py)
    for kw in ({}, {"sketch_size": SKETCH}):
        for method, rtol in (("ridge-lss", 1e-4), ("l2-hull", 5e-3)):
            res = {}
            for where in ("cpu", "cuda"):
                eng = ScoringEngine(cfg, scaler, chunk_size=1000, device=where)
                res[where] = eng.score(Yn, method=method, hull_k=40,
                                       generator=torch.Generator().manual_seed(3), **kw)
            a, b = res["cuda"].scores, res["cpu"].scores
            rel = float(np.max(np.abs(a - b) / np.abs(b)))
            log(f"small input {kw or 'two-pass'} {method}: max score rel err {rel:.3e}")
            if a.shape != (3001,) or not np.all(np.isfinite(a)) or rel > rtol:
                fail(f"scores on the card disagree with the CPU path {kw} {method}")
    idx = np.arange(0, 3001, 7)
    w = np.linspace(0.5, 2.0, idx.size).astype(np.float32)
    fits = {}
    for where in ("cpu", "cuda"):
        init = M.init_params(cfg, normals=np.zeros((cfg.J, cfg.d), np.float32), device=where)
        fits[where] = fit_mctm_streaming(cfg, scaler, Yn[idx], weights=w, init=init, steps=30,
                                         chunk_size=100, device=where)
    a, b = fits["cuda"].final_nll, fits["cpu"].final_nll
    if not np.isfinite(a) or abs(a - b) > 1e-4 * abs(b):
        fail(f"fit on the card disagrees with the CPU path: {a} vs {b}")
    log(f"small input fit: final NLL {a:.6f} (card) vs {b:.6f} (CPU)")


def main() -> None:
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        fail("src/repro_torch is missing: run chip_smoke.py from a checkout of the repository")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs the card")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = phase_environment()
    kernels = phase_kernels(dev)
    phase_small_agreement(dev)
    launches = phase_path(dev)
    for row in kernels:
        row["launches"] = launches[row["name"]]
        if row["launches"] <= 0:
            fail(f"kernel {row['name']} was not launched on the main path")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
