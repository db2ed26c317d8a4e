"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA H100: builds the kernels from this checkout's sources, holds each
kernel against its plain PyTorch version at its path's shapes, drives the
Algorithm 1 path end to end through ``repro_torch.launch.train_mctm``
(two-pass, then one-pass), the LM serving path through ``ServeEngine`` and
the LM training path through ``repro_torch.launch.train`` at full width
(tinyllama-1.1b, then mamba2-370m), and checks that every kernel of each
path ran.

    python3 chip_smoke.py

Phases (any failure exits nonzero):
  1. environment: card, power limit, torch/CUDA/nvcc versions, Triton, build time,
     and ptxas's registers and spills of the redesigned bodies (flash_attention's
     wgmma body, gram's cluster kernel and its tiled kernel at the run widths of
     D 70 and 140, ssd's three mma-body kernels, bernstein at degrees 6 and 15);
  2. each kernel vs its plain version on the card (the four MCTM kernels,
     flash_attention and ssd), timed by CUDA events (``ms``, which also read the
     host's issue rate) and by the device time of its kernels from
     torch.profiler (``device_ms``); where one PyTorch call computes the same
     function, kernel and call are timed in turns (kernel, call, call,
     kernel) and their ratios printed; ssd's errors as shares of their
     tolerances, its mma body timed at T = 256 and 1,024 beside its f32
     CUDA-core and bf16×3 tensor-core bounds, bernstein at n = 250,001 and at
     one 16,384-row chunk; ssd, gram, bernstein, extremes and sweep give the
     same bits on repeated calls; extremes (values and indices) and the
     sweep's SX' and extremes are bit-identical to their plain versions, and
     extremes and sweep run two device kernels a call (their parent design's
     device times in brackets); gram and sweep also at one chunk of the
     paper's J = 10 (covertype) and J = 20 (equity) at degree 6, gram's tiled
     body (D 70, 140) against float64 and in turns with torch.mm (its parent
     design's device times in brackets; its bound also from three TF32
     tensor-core products a product), the sweep at the default one-pass
     sketch 4·D² (19,600 and 78,400); beside them the extremes kernel's wide
     body (d > 16) at d = 70 and 140 on the J = 10 and J = 20 feature chunks
     (1,614 directions) and at d = 1,024 (128 directions), bit-identical to its
     plain version (whole and ragged), timed in turns with ``dirs @ P.T`` +
     ``max``/``min``, and its own path, the hull API on the J = 10 feature rows
     (ε-kernel k = 400, a 64-step greedy projection: 65 wide launches);
  3. the path at n = 250,001 (normal_mixture, J = 2, degree 6, chunk 16,384,
     α = 0.8, k = 500 and 2000, 250 steps at lr 0.05): two-pass with the
     driver's default full-data fit, the streaming lbfgs (gtol 1e-5; its time,
     iterations, sweeps and the bernstein launches inside it are printed and
     checked), one-pass with an adam full-data fit, adam coreset fits on both;
     every ratio must lie in its band; plus the path's scores and its adam and
     lbfgs fits held against the plain (CPU) path on a small input, and the
     scoring of J = 10 covertype (n = 50,000, both strategies) on the card
     against the CPU path (identical features: the same hull rows) and
     two-pass against float64 of each side's own features (a second draw
     too), with a TF32-Gram and a bf16-feature control that the same limit
     must reject; gram's tiled body counted over the path's card runs, the
     controls not;
  4. the serve path: the reduced LMs on the card against the CPU at f32
     (same greedy tokens, logits within 1e-4), then each full-width model
     from a seeded generator on the card serving 8 greedy requests (prompts
     256–1024 tokens, 32 new tokens each) through 4 slots of 2,048
     positions; every logit finite, and the engine's logits held against a
     single-request teacher-forced run of the same model; then, with
     ``torch.profiler``, the device's busy time and idle share over one
     1,024-token prefill (with the kernel's share of its device time) and over
     8 batched decode ticks; tinyllama's prefills must all take
     flash_attention's wgmma body and mamba2's all take ssd's mma body (their
     own launch counters);
  6. the paper's core beyond Algorithm 1's path (it runs after phase 4,
     but for gram and the sweep at the conditional width D = 16, the sweep
     held to its plain version, which run beside phase 2): the conditional Algorithm 1 at n = 250,001 (J = 2,
     degree 6, F = 2 features, so D = 16: tests/test_conditional.py's
     linear shift), the
     adam full fit and both builds at k = 500 and 2000 with adam coreset
     fits, gated on exactly k ids, distinct hull ids, the reference test's
     cNLL bound and β's direction; on its 4,000-point fixture the card
     against the CPU (scores on identical features and on own featurize,
     each against float64 of its features, with a TF32-Gram control; the
     build's hull overlap; adam and lbfgs fits); the paper's Table 1
     workflow through ``evaluate_coreset`` (normal_mixture, n = 10,000,
     700-step adam fits, k = 30 and 100, five methods; l2-hull at k = 100
     held against the CPU); and the standalone API at the path's width:
     the five leverage variants against float64 (relative, each beside a
     TF32-Gram or bf16 control the limit must reject),
     ``epsilon_kernel_indices`` (k = 400) and ``greedy_hull_projection``
     against their plain versions on the card, ``sample`` against the CPU
     on the same normals, and ``gram_dtype="float64"`` scoring card against
     CPU;
  7. fault tolerance at the path's width (n = 250,001, chunk 16,384, a sweep
     checkpoint every 4 chunks): two-pass and one-pass builds crashed in
     sweep 1 (chunk 6) and sweep 2 (two-pass, chunk 11) and driven to
     completion through ``RunSupervisor`` with ``resume=ctx.resume``: scores,
     hull rows and Gram equal to the uninterrupted build's bits, with the
     checkpointed build's time and bytes beside the plain build's; adam (250
     steps, a checkpoint every 50, crashes at step 120 and at the step-200
     save) and lbfgs (a crash at step 30) on the k = 2,000 coreset recovered
     to the straight run's bits, two straight runs first held to each
     other; the finiteness read's cost in turns; a NaN-weighted fit aborting
     with the supervisor's diagnostic; and the driver's drill
     (``train_mctm --inject-failures --n 50001 --ks 500 --steps 250``: three
     injections recovered, the ratio in its band);
  8. streaming: 16 windows × 65,536 rows of normal_mixture (1,048,576
     points, J = 2, degree 6, k = 2,000, α = 0.8) through four maintainers
     (insertion with sketch 784 and exact, sliding W = 4, decayed γ = 0.9):
     push and result() times, live buckets, the sliding window's births and
     mass and the decayed closed form exact, result() idempotent; the
     insertion stream killed at window 9, resumed from its checkpoint and
     re-pushed to the uninterrupted result's bits; one batch build over the
     whole prefix against a maintained window; result()'s weighted NLL at
     fixed parameters within rel 0.3 of the full data's
     (tests/test_streaming.py's bound), an adam refit on it against the full
     fit (reported); the drift detector silent over 6 clean windows and
     firing within 6 shifted ones (rows·1.6 + 2·std);
  9. the data pipeline and the minibatch fit: gram's large body (D > 160)
     at D = 2,048, the sweep at D = 2,048 and the wide-P route (P = X, d =
     2,048: the extremes kernel's wide body and gram beside the sweep) on
     one 16,384-row chunk of pooled embeddings, held to their plain
     versions and timed (gram in turns with torch.mm, the sweep with
     index_add_); ``CoresetSelector`` (l2-hull, k = 2,048, α = 0.8),
     two-pass and one-pass, at D = 32 (launch/train.py's proxy: a 32,000 ×
     32 projection mean-pooled over 262,144 sequences of 64 ids, sketch
     4,096) and D = 2,048 (tinyllama-1.1b's embedding table pooled over
     65,536 sequences of 256 ids, chunk 16,384, sketch 16,384): scores
     against float64 of the same features beside a TF32-Gram (two-pass) or
     bf16-feature (one-pass) control that must fail, the hull ids against
     the plain versions' selection on the card, Σ weights against n; the
     minibatch fit at n = 250,001 (batch 4,096, 250 steps, both sampling
     modes) beside phase 3's adam full fit, with backup draws forced by a
     straggler deadline and a crash at step 120 recovered to the straight
     run's bits;
 10. density serving: ``launch/serve_mctm.py`` at its defaults (captures
     in warmup and after it, latency per kind, queries/s, the refit's
     build, fit and publish times; no dropped or mixed-version answer, each
     log density within 1e-4 of ``mctm.log_density`` of its version), then
     the maintainer's drift → refit → publish loop on phase 8's
     clean-then-shifted stream (6 clean, 8 shifted windows);
 11. the data mesh at the path's width (n = 250,001, k = 500 and 2000,
     two-pass and one-pass at sketch 784): an NCCL world of 1 gives the
     single-device bits (builds, ``streamed_nll``, a 250-step adam fit);
     gloo worlds of 2 and 4 whose ranks share the card hold their
     f64-Gram scores to world 1's, their f32 ridge-lss scores to float64 of
     the same features (beside a TF32-Gram control at each world and a
     bf16-feature control), their
     coresets to the same bits on every rank and their collectives to one
     fold a sweep and one gather pair; a crashed segmented sweep at world
     2 resumes to the same bits; per-rank ``build_s`` and fold bytes;
 12. LM training through ``launch/train.py``: tinyllama-1.1b and mamba2-370m
     at their published widths and depths, bf16 activations and float32
     masters (``--coreset l2-hull --coreset-k 512 --batch 8 --seq 64``, 30
     steps at lr 1e-3): finite losses, the last 5 steps' mean below the
     first 5's, no launch of flash_attention or ssd (training runs the plain
     attention and SSD scan, as the reference trains through its jnp twins)
     and gram and extremes launched in the coreset stage; step ms (median of
     steps 5–30), tokens/s, peak memory, the device's busy share over a
     3-step profiler window, ``select_s``; ``examples/train_lm_coreset.py``'s
     comparison at tinyllama's full width (k = 256 of 2,048 examples
     featurized by the mean of the embeddings, D = 2,048: gram's large body
     and the wide-P route; l2-hull against uniform from the same weights,
     the gap printed, no gate on its sign); a crash-and-resume drill on
     mamba2-370m (crashed at step 7 of 10, resumed from step 5's checkpoint
     to the straight run's bits); the reduced configs in f32, 5 steps on the
     card and on the CPU from the same weights and batches, losses within
     1e-4 relative;
 13. the invariant auditor on the card (``repro_torch.analysis``): every
     registered program (the fit steps and oracles, the streamed and drift
     evaluators, the sharded sweeps of ``DistributedScoringEngine`` and their
     resumable segments on rank 0 of a fake world of 8, serving, the kernel
     wrappers) audited on the CPU under fake tensors and on the card for
     real at the audit shapes, the scoring, fit and drift programs also at
     phase 3's width (J = 2, degree 6, chunk 16,384, rank 0 of 8 over
     n = 250,001): each clean against its budgets (its census, host reads
     as synchronizing calls, kernel launches, float64 arrays, in-place
     state), the card's census equal to the CPU's, each of the five
     violations caught on the card; then the pod dry run's eight records
     (``launch/dryrun_coreset.py``: four variants on the 16×16 and 2×16×16
     meshes, traced on the CPU) with their roofline terms;
  5. launch census: each kernel counted over its own path's run, and over
     each of phases 6–13's paths (``launches_phase6`` to
     ``launches_phase13``; graph replays of the serving engine counted
     apart).
The last line is ``{"ok": true, "device": {...}}``; the line before it the
card's name and power limit; before that the ``kernels`` JSON line. The
numbers are also written to ``results/chip_smoke.json``.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
if os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
    # the H100 SXM data sheet's peaks, kept once, in launch/roofline.py
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.launch.roofline import F32_FLOPS as H100_F32_FLOPS
    from repro_torch.launch.roofline import HBM_BW as H100_BYTES_PER_S
    from repro_torch.launch.roofline import PEAK_FLOPS as H100_BF16_FLOPS
    from repro_torch.launch.roofline import TF32_FLOPS as H100_TF32_FLOPS
else:  # outside a checkout: main() refuses to run
    H100_F32_FLOPS = H100_BYTES_PER_S = H100_BF16_FLOPS = H100_TF32_FLOPS = None
MAIN_N = 250_001
CHUNK = 16_384
SKETCH = 784                 # 4·(J·d)² at J = 2, d = 7
KS = (500, 2000)
# device ms of the previous design of the extremes and sweep kernels and of
# gram's tiled body at the paths' shapes, the mean of the two runs PERF.md §6
# records (NVIDIA H100 80GB HBM3 at 700.00 W): logged in brackets beside this
# run's, never in the kernels line, which holds this run's measurements only
PARENT_DEVICE_MS = {"extremes": 0.06264, "sweep": 0.11590, "gram D=70": 0.02606,
                    "gram D=140": 0.04617, "sweep D=2048": 0.70837}
WIDE_J = (10, 20)            # table2_covertype.py (J = 10), table5_equity.py (J = 20)


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
    for line in ptxas_report(_lib.BUILD_LOG):
        log(line)
    return smi.splitlines()[0] if smi else smi


# redesigned kernels → the template arguments to report (None: every one)
REDESIGNED = {"flash_wgmma_kernel": None, "gram_cluster_kernel": None,
              "gram_tiled_kernel": ("2", "6"),
              "ssd_state_kernel": None, "ssd_pass_kernel": None, "ssd_scan_mma_kernel": None,
              "bernstein_featurize_kernel": ("6", "15"), "extremes_score_kernel": ("7",),
              "extremes_fold_kernel": ("7", "0"), "extremes_wide_kernel": None,
              "gram_large_kernel": None,
              "sweep_main_kernel": ("7",),
              "sweep_fold_kernel": ("7",)}


def ptxas_report(build_log: dict) -> list[str]:
    """Registers, static shared memory and spills that ptxas reported for
    the redesigned bodies, and every warning of the build."""
    out = []
    for src, text in build_log.items():
        lines = text.splitlines()
        for i, line in enumerate(lines):
            if "warning" in line.lower():
                out.append(f"nvcc {src}: {line.strip()}")
            if "Compiling entry function" in line and any(k in line for k in REDESIGNED):
                name = next(k for k in REDESIGNED if k in line)
                # integer template arguments (head width, degree, P and warps per tile)
                args = re.findall(r"Li(\d+)E", line.split(name, 1)[1].split("'")[0])
                keep = REDESIGNED[name]
                if keep is not None and (not args or args[0] not in keep):
                    continue
                tmpl = f"<{', '.join(args)}>" if args else ""
                info = " | ".join(x.strip().replace("ptxas info    : ", "")
                                  for x in lines[i + 2:i + 4])
                out.append(f"ptxas {name}{tmpl}: {info}")
    return out


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


CLEAN_WINDOW_TRIES = 5


def clean_window(fn, iters: int = 20) -> dict:
    """``profile_window`` over ``iters`` calls of ``fn``, taken again (up to
    CLEAN_WINDOW_TRIES times) while its kernel count is zero or no multiple
    of ``iters``: the profiler has been seen to drop kernel records from a
    window, and a window short of kernels reports a time short of them, so
    it raises when every try lost records."""
    fn()
    for _ in range(CLEAN_WINDOW_TRIES):
        w = profile_window(lambda: [fn() for _ in range(iters)])
        if w["device_launches"] and w["device_launches"] % iters == 0:
            return w
        log(f"  profiler window lost kernel records ({w['device_launches']} kernels over "
            f"{iters} calls); measuring again")
    raise RuntimeError(f"every one of {CLEAN_WINDOW_TRIES} profiler windows lost kernel "
                       f"records ({w['device_launches']} kernels over {iters} calls)")


def device_ms(fn, iters: int = 20) -> float:
    """Per-call device time of ``fn``: the summed durations of the kernels
    it launches over ``iters`` calls (``clean_window``), over ``iters``.
    Unlike ``cuda_ms`` it does not read the host's issue rate."""
    return clean_window(fn, iters)["device_busy_ms"] / iters


def in_turns(kernel, library) -> dict:
    """Kernel and library call timed in turns (kernel, library, library,
    kernel), by CUDA events and by device time; ms are the means of each
    pair, ratios kernel ÷ library."""
    order = (kernel, library, library, kernel)
    ev = [cuda_ms(f) for f in order]
    dv = [device_ms(f) for f in order]
    out = {"ms": (ev[0] + ev[3]) / 2, "library_ms": (ev[1] + ev[2]) / 2,
           "device_ms": (dv[0] + dv[3]) / 2, "library_device_ms": (dv[1] + dv[2]) / 2,
           "turns_ms": ev, "turns_device_ms": dv}
    out["ratio"] = out["ms"] / out["library_ms"]
    out["device_ratio"] = out["device_ms"] / out["library_device_ms"]
    return out


def bound_ms(nbytes: float, flops: float, peak: float = H100_F32_FLOPS) -> tuple[float, str]:
    tb, tf = nbytes / H100_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def kernel_row(name, source, replaces, err, kernel, plain, library, nbytes, flops,
               peak=H100_F32_FLOPS) -> dict:
    """One row of the ``kernels`` line, timing ``kernel``, ``plain`` and
    ``library`` (None where no single PyTorch call computes the function;
    otherwise timed in turns with the kernel); launches are filled in from
    the path's run."""
    b, by = bound_ms(nbytes, flops, peak)
    if library is None:
        t = {"ms": cuda_ms(kernel), "library_ms": None, "device_ms": device_ms(kernel),
             "library_device_ms": None}
    else:
        t = in_turns(kernel, library)
        log(f"kernel {name} in turns (kernel, library, library, kernel): events "
            f"{[round(x, 5) for x in t['turns_ms']]} ms, ratio {t['ratio']:.3f}; device "
            f"{[round(x, 5) for x in t['turns_device_ms']]} ms, ratio {t['device_ratio']:.3f}")
    plain_ms = cuda_ms(plain)
    lib = t["library_ms"]
    log(f"kernel {name}: max_abs_err {err:.3e}  kernel {t['ms']:.5f} ms (device "
        f"{t['device_ms']:.5f})  plain {plain_ms:.4f} ms  library "
        f"{lib if lib is None else f'{lib:.5f}'} ms  bound {b:.5f} ms ({by}; "
        f"{nbytes / 1e6:.3f} MB, {flops / 1e9:.4f} GFLOP at {peak / 1e12:g} TFLOP/s)")
    out = {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": 0, "max_abs_err": err, "ms": t["ms"], "plain_ms": plain_ms,
        "bound_ms": b, "bound_by": by, "library_ms": lib, "device_ms": t["device_ms"],
        "library_device_ms": t["library_device_ms"],
    }
    if library is not None:
        out["turns_device_ms"] = t["turns_device_ms"]
    return out


def same_bits(a, b) -> bool:
    """Equal to the bit (±0 and NaN payloads included), on any devices."""
    import torch

    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.view(torch.int32).cpu(), b.view(torch.int32).cpu())


def featurized_chunk(dev, J: int):
    """One CHUNK-point chunk at degree 6 of the paper's wider tables: J = 10
    on covertype (table2_covertype.py), J = 20 on equity returns
    (table5_equity.py) → (X (c, 7J), P (c·J, 7)) from the port's featurize."""
    import numpy as np
    import torch

    from repro_torch.core import mctm as M
    from repro_torch.core.bernstein import DataScaler
    from repro_torch.core.scoring import _mctm_featurize
    from repro_torch.data import generate_covertype, generate_equity_returns

    Yn = generate_covertype(CHUNK, seed=0) if J == 10 else generate_equity_returns(CHUNK, J, seed=0)
    Yn = Yn.astype(np.float32)
    return _mctm_featurize(M.MCTMConfig(J=J, degree=6), DataScaler.fit(Yn))(
        torch.as_tensor(Yn, device=dev))


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
    from repro_torch.kernels.gram import ops as gram
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

    def row(*args, **kw):
        rows_all.append(kernel_row(*args, **kw))

    # ---- bernstein: all n = 250,001 points at once (the dense featurize)
    A, Ap = bernstein_featurize(Y, bounds, cfg.degree)
    Ar, Apr = bernstein_featurize_ref(Y, bounds, cfg.degree)
    torch.cuda.synchronize()
    err = max(max_err(A, Ar), max_err(Ap, Apr))
    if not (close(A, Ar, rtol=0, atol=1e-6) and close(Ap, Apr, rtol=0, atol=1e-6)):
        errs.append(f"bernstein disagrees with its plain version: {err}")
    again = [bernstein_featurize(Y, bounds, cfg.degree) for _ in range(3)]
    if not all(torch.equal(A, a) and torch.equal(Ap, ap) for a, ap in again):
        errs.append("bernstein is not bit-identical across calls")
    nv = MAIN_N * cfg.J
    row("bernstein", "src/repro_torch/csrc/bernstein.cu",
        "src/repro/kernels/bernstein/kernel.py:48", err,
        lambda: bernstein_featurize(Y, bounds, cfg.degree),
        lambda: bernstein_featurize_ref(Y, bounds, cfg.degree), None,
        nbytes=4 * nv + 4 * bounds.numel() + 2 * 4 * nv * d,
        flops=nv * (7 + 2 * cfg.degree + 2 * d + 2 * cfg.degree + 3 * d))
    # the fit's launches run at one chunk of rows, not at the whole n
    Yc = Y[:CHUNK].contiguous()
    nc = CHUNK * cfg.J
    bc, _ = bound_ms(4 * nc + 4 * bounds.numel() + 2 * 4 * nc * d, 0)
    dc = device_ms(lambda: bernstein_featurize(Yc, bounds, cfg.degree))
    log(f"  bernstein at one {CHUNK:,}-row chunk: device {dc:.5f} ms, events "
        f"{cuda_ms(lambda: bernstein_featurize(Yc, bounds, cfg.degree)):.5f} ms, "
        f"bound {bc:.5f} ms (bytes), {bc / dc:.3f} of it")

    # ---- gram: one (16,384, 14) chunk, √w = 1, accumulated into G as on
    # the main path (pass1_update); one launch, bit-identical on every call
    G0 = gram_ref(X[:4096], sw[:4096])
    G = gram_matrix(X, sw, acc=G0)
    Gr = gram_ref(X.double(), sw.double(), acc=G0.double())
    again = [gram_matrix(X, sw, acc=G0) for _ in range(3)]
    separate = G0 + gram_matrix(X, sw)
    torch.cuda.synchronize()
    err = max_err(G, Gr)
    if err > 1e-5 * float(Gr.abs().max()):
        errs.append(f"gram disagrees with its plain version in float64: {err}")
    if not all(torch.equal(G, a) for a in again) or not torch.equal(G, separate):
        errs.append("gram is not bit-identical across calls, or with acc= against the add")
    log(f"  gram vs float64: max abs err {err:.3e} of max|G| {float(Gr.abs().max()):.3e}; "
        "bit-identical over repeated calls and with the separate add")
    calls = 20
    prof = clean_window(lambda: gram_matrix(X, sw, acc=G0), calls)
    log(f"  gram: {prof['device_launches']} device kernels over {calls} calls with acc= "
        f"({prof['top_kernels_ms']})")
    if prof["device_launches"] != calls:
        errs.append(f"gram ran {prof['device_launches']} device kernels over {calls} calls")
    row("gram", "src/repro_torch/csrc/gram.cu", "src/repro/kernels/gram/kernel.py:30", err,
        lambda: gram_matrix(X, sw, acc=G0), lambda: gram_ref(X, sw, acc=G0),
        lambda: torch.mm(X.T, X),
        nbytes=4 * (CHUNK * D + CHUNK + 2 * D * D), flops=CHUNK * (D + D * (D + 1)))

    # ---- gram's tiled body, 64 < D ≤ 160: one chunk at J = 10 and 20, in
    # turns with torch.mm; J = 10's is the tiled body's row of the kernels line
    wide = {J: featurized_chunk(dev, J) for J in WIDE_J}
    extra = {}
    for J, (Xw, _) in wide.items():
        Dw = Xw.shape[1]
        sww = torch.rand(CHUNK, generator=gen).to(dev)
        Ga = torch.randn(Dw, Dw, generator=gen).to(dev)
        tiled0 = gram.PATH_LAUNCHES["tiled"]
        Gw = gram_matrix(Xw, sww, acc=Ga)
        Gr = gram_ref(Xw.double(), sww.double(), acc=Ga.double())
        again = [gram_matrix(Xw, sww, acc=Ga) for _ in range(3)]
        separate = Ga + gram_matrix(Xw, sww)
        torch.cuda.synchronize()
        err = max_err(Gw, Gr)
        if err > 1e-5 * float(Gr.abs().max()):
            errs.append(f"gram D={Dw} disagrees with its plain version in float64: {err}")
        if not all(torch.equal(Gw, a) for a in again) or not torch.equal(Gw, separate):
            errs.append(f"gram D={Dw} is not bit-identical across calls or with acc=")
        if gram.PATH_LAUNCHES["tiled"] - tiled0 != 5:
            errs.append(f"gram D={Dw} did not take the tiled body")
        prof = clean_window(lambda: gram_matrix(Xw, sww, acc=Ga), calls)
        if prof["device_launches"] != calls:
            errs.append(f"gram D={Dw} ran {prof['device_launches']} device kernels over {calls}")
        nbytes = 4 * (CHUNK * Dw + CHUNK + 2 * Dw * Dw)
        flops = CHUNK * (Dw + Dw * (Dw + 1))
        # the tiled body's own arithmetic, its bound: three TF32 tensor-core
        # products (lo·hi, hi·lo, hi·hi) for each product of the upper
        # triangle; the f32 FMA bound of the same Gram beside it
        b3, by3 = bound_ms(nbytes, 3 * CHUNK * Dw * (Dw + 1), H100_TF32_FLOPS)
        if J == WIDE_J[0]:
            row("gram_tiled", "src/repro_torch/csrc/gram.cu", "src/repro/kernels/gram/kernel.py:30",
                err, lambda: gram_matrix(Xw, sww, acc=Ga), lambda: gram_ref(Xw, sww, acc=Ga),
                lambda: torch.mm(Xw.T, Xw), nbytes=nbytes, flops=3 * CHUNK * Dw * (Dw + 1),
                peak=H100_TF32_FLOPS)
            r = rows_all[-1]
            t = {k: r[k] for k in ("ms", "library_ms", "device_ms", "library_device_ms")}
            t["device_ratio"] = r["device_ms"] / r["library_device_ms"]
            t["turns_device_ms"] = r["turns_device_ms"]
        else:
            t = in_turns(lambda: gram_matrix(Xw, sww, acc=Ga), lambda: torch.mm(Xw.T, Xw))
        b, by = bound_ms(nbytes, flops)
        extra[f"gram_D{Dw}"] = dict(t, bound_ms=b, bound_by=by, bound_tf32x3_ms=b3,
                                    bound_tf32x3_by=by3, max_abs_err=err)
        W, runs = gram.tiled_plan(Dw)
        log(f"  gram J={J} ({CHUNK:,}, {Dw}) tiled body: max abs err {err:.3e} of max|G| "
            f"{float(Gr.abs().max()):.3e}; device {t['device_ms']:.5f} ms (parent "
            f"[{PARENT_DEVICE_MS[f'gram D={Dw}']}]) vs torch.mm {t['library_device_ms']:.5f} ms "
            f"(ratio {t['device_ratio']:.3f}, in turns {[round(x, 5) for x in t['turns_device_ms']]}); "
            f"events {t['ms']:.5f} vs {t['library_ms']:.5f} ms; bound {b:.5f} ms ({by}), "
            f"{b / t['device_ms']:.3f} of it; TF32x3 tensor-core bound {b3:.5f} ms ({by3}), "
            f"{b3 / t['device_ms']:.3f} of it; {prof['device_launches'] // calls} device kernel a "
            f"call, run width {W} tiles in {len(runs)} warps")

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
            again = [directional_extremes(Pc, dirs[k], nv_rows) for _ in range(2)]
            torch.cuda.synchronize()
            mism = int((got[1] != ref[1]).sum()) + int((got[3] != ref[3]).sum())
            e = max(max_err(got[0], ref[0]), max_err(got[2], ref[2]))
            bits = all(same_bits(g, r) for g, r in zip(got, ref))
            stable = all(same_bits(g, a) for ag in again for g, a in zip(got, ag))
            ext_err = max(ext_err, e)
            log(f"  extremes m={dirs[k].shape[0]} {tag}: index mismatches {mism}, "
                f"max value err {e:.3e}, bit-identical {bits}, same bits on repeat {stable}")
            if mism or not bits or not stable:
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
        lambda: directional_extremes(P, dk), lambda: directional_extremes_ref(P, dk),
        library_extremes,
        nbytes=4 * (P.numel() + dk.numel() + 4 * m), flops=2 * m * P.shape[0] * d)
    ex_row = rows_all[-1]
    ex_row["device_kernels_per_call"] = kernels_per_call(
        lambda: directional_extremes(P, dk), errs, "extremes", 2)
    log(f"  extremes: device {ex_row['device_ms']:.5f} ms (parent "
        f"[{PARENT_DEVICE_MS['extremes']}]), {ex_row['bound_ms'] / ex_row['device_ms']:.3f} "
        f"of its bound, {ex_row['device_kernels_per_call']} device kernels a call")

    # ---- sweep: sketch 784, with and without Ω, with and without moments,
    # from a nonzero carry
    rows_p, signs_p = sketch_plan(CHUNK, SKETCH, generator=gen, device=dev)
    SX0 = torch.randn((SKETCH, D), generator=gen).to(dev)
    omega = torch.randn((D, 8), generator=gen).to(dev) / np.sqrt(8)
    mom0 = (torch.randn(d, generator=gen).to(dev), torch.randn((d, d), generator=gen).to(dev))
    up = torch.as_tensor(upfront_directions(d, KS[-1] - int(0.8 * KS[-1]), generator=gen),
                         device=dev)
    sweep_err = 0.0
    for om in (None, omega):
        for mom in (None, mom0):
            tag = f"omega={'on' if om is not None else 'off'} moments={'on' if mom else 'off'}"
            sweep_err = max(sweep_err, check_sweep(
                tag, SX0, X, P, sw, rows_p, signs_p, up, om, CHUNK - 77, mom, errs))
    mu = up.shape[0]
    row("sweep", "src/repro_torch/csrc/sweep.cu", "src/repro/kernels/sweep/kernel.py:136",
        sweep_err,
        lambda: fused_sweep_update(SX0, X, P, sw, rows_p, signs_p, dirs=up),
        lambda: fused_sweep_ref(SX0, X, P, sw, rows_p, signs_p, dirs=up), None,
        nbytes=4 * (2 * CHUNK * D + P.numel() + 3 * CHUNK + up.numel() + 2 * SKETCH * D
                    + 4 * mu),
        flops=CHUNK * 2 * D + 2 * mu * P.shape[0] * d)
    sw_row = rows_all[-1]
    sw_row["device_kernels_per_call"] = kernels_per_call(
        lambda: fused_sweep_update(SX0, X, P, sw, rows_p, signs_p, dirs=up), errs, "sweep", 2)
    log(f"  sweep: device {sw_row['device_ms']:.5f} ms (parent [{PARENT_DEVICE_MS['sweep']}]), "
        f"{sw_row['bound_ms'] / sw_row['device_ms']:.3f} of its bound, "
        f"{sw_row['device_kernels_per_call']} device kernels a call")
    # the sketch alone (no P rows, no z) against the one PyTorch call that
    # computes it, index_add_, as phase 9 times the sweep at D = 2,048
    sgn_w = signs_p * sw
    t = in_turns(lambda: fused_sweep_update(SX0, X, None, sw, rows_p, signs_p, want_z=False),
                 lambda: SX0.clone().index_add_(0, rows_p.long(), X * sgn_w[:, None]))
    b, by = bound_ms(4 * (CHUNK * D + 3 * CHUNK + 2 * SKETCH * D), 2 * CHUNK * D)
    sw_row["sketch_only"] = dict(t, bound_ms=b, bound_by=by)
    log(f"  sweep D={D} sketch only: device {t['device_ms']:.5f} ms vs index_add_ "
        f"{t['library_device_ms']:.5f} ms (ratio {t['device_ratio']:.3f}, in turns "
        f"{[round(x, 5) for x in t['turns_device_ms']]}); events {t['ms']:.5f} vs "
        f"{t['library_ms']:.5f} ms; bound {b:.5f} ms ({by})")

    # ---- sweep at the default one-pass sketch 4·D² of J = 10 and 20
    for J, (Xw, Pw) in wide.items():
        Dw, skw = Xw.shape[1], 4 * Xw.shape[1] ** 2
        sww = torch.ones(CHUNK, device=dev)
        rw, sgw = sketch_plan(CHUNK, skw, generator=gen, device=dev)
        SXw = torch.randn((skw, Dw), generator=gen).to(dev)
        momw = (torch.zeros(d, device=dev), torch.zeros((d, d), device=dev))
        tag = f"J={J} D={Dw} sketch={skw:,} m={mu}"
        check_sweep(tag, SXw, Xw, Pw, sww, rw, sgw, up, None, CHUNK, momw, errs)
        call = lambda: fused_sweep_update(SXw, Xw, Pw, sww, rw, sgw, dirs=up)  # noqa: E731
        dms, ems = device_ms(call), cuda_ms(call)
        b, by = bound_ms(4 * (2 * CHUNK * Dw + Pw.numel() + 3 * CHUNK + up.numel()
                              + 2 * skw * Dw + 4 * mu), CHUNK * 2 * Dw + 2 * mu * Pw.shape[0] * d)
        extra[f"sweep_J{J}"] = {"device_ms": dms, "ms": ems, "bound_ms": b, "bound_by": by,
                                "sketch": skw, "D": Dw}
        log(f"  sweep {tag}: device {dms:.5f} ms, events {ems:.5f} ms, bound {b:.5f} ms ({by}), "
            f"{b / dms:.3f} of it")
    if errs:
        fail("; ".join(errs))
    return rows_all, extra


# the wide extremes body (d > 16): the J = 10 and J = 20 feature chunks (the
# hull queries data/pipeline.py's CoresetSelector runs on feature rows) with
# the path's 1,614 directions, d = 1,024 with 128 directions, and the greedy
# hull walk's one direction at d = 70
WIDE_EXTREMES = ((70, 1614), (140, 1614), (1024, 128), (70, 1))


def phase_wide_extremes(dev):
    """The extremes kernel's wide body beside phase 2 (profiler windows
    after phase 4 drop records): each case held to its plain version to the
    bit (whole, ragged validity, repeated), timed in turns with ``dirs @
    P.T`` + ``max``/``min``, its tile plan recorded; then its own path, the
    hull API on the J = 10 feature rows (ε-kernel k = 400 and a 64-step
    greedy projection), counted and held to the plain version. Returns (the
    ``extremes_wide`` row of the kernels line, from the first case;
    records)."""
    import torch

    from repro_torch.core import hull as H
    from repro_torch.kernels.extremes import ops as ext
    from repro_torch.kernels.extremes.ops import directional_extremes
    from repro_torch.kernels.extremes.ref import directional_extremes_ref

    errs: list[str] = []
    gen = torch.Generator().manual_seed(17)
    feats = {70: featurized_chunk(dev, 10)[0].contiguous(),
             140: featurized_chunk(dev, 20)[0].contiguous(),
             1024: torch.randn((CHUNK, 1024), generator=gen).to(dev)}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rec, row = {}, None
    for d, m in WIDE_EXTREMES:
        P = feats[d]
        dirs = torch.randn((m, d), generator=gen).to(dev)
        w0 = ext.PATH_LAUNCHES["wide"]
        bits, err = {}, 0.0
        for tag, nv in (("whole", CHUNK), ("ragged", CHUNK - 1001)):
            got = directional_extremes(P, dirs, nv)
            ref = directional_extremes_ref(P, dirs, nv)
            again = directional_extremes(P, dirs, nv)
            torch.cuda.synchronize()
            err = max(err, max_err(got[0], ref[0]), max_err(got[2], ref[2]))
            bits[tag] = (all(same_bits(g, r) for g, r in zip(got, ref))
                         and all(same_bits(g, a) for g, a in zip(got, again)))
            if not bits[tag]:
                mism = int((got[1] != ref[1]).sum()) + int((got[3] != ref[3]).sum())
                errs.append(f"wide extremes d={d} m={m} {tag}: not its plain version's bits "
                            f"({mism} index mismatches)")
        if ext.PATH_LAUNCHES["wide"] - w0 != 4:
            errs.append(f"wide extremes d={d} did not take the wide body")

        def library(P=P, dirs=dirs):
            S = dirs @ P.T
            return S.max(dim=1), S.min(dim=1)

        nbytes, flops = 4 * (P.numel() + dirs.numel() + 4 * m), 2 * m * CHUNK * d
        kernel = lambda P=P, dirs=dirs: directional_extremes(P, dirs)  # noqa: E731
        plain = lambda P=P, dirs=dirs: directional_extremes_ref(P, dirs)  # noqa: E731
        if (d, m) == WIDE_EXTREMES[0]:
            row = kernel_row("extremes_wide", "src/repro_torch/csrc/extremes.cu",
                             "src/repro/kernels/extremes/kernel.py:66", err, kernel, plain,
                             library, nbytes=nbytes, flops=flops)
            t = {k: row[k] for k in ("ms", "library_ms", "device_ms", "library_device_ms",
                                     "bound_ms", "bound_by", "plain_ms")}
            t["turns_device_ms"] = row["turns_device_ms"]
            row["device_kernels_per_call"] = kernels_per_call(kernel, errs, "wide extremes", 2)
        else:
            t = in_turns(kernel, library)
            t["bound_ms"], t["bound_by"] = bound_ms(nbytes, flops)
            t["plain_ms"] = cuda_ms(plain, iters=3, warmup=1)
        t["same_bits"] = bits
        t["plan"] = ext.wide_launch_plan(CHUNK, m, sms)._asdict()
        rec[f"d{d}_m{m}"] = t
        log(f"  extremes wide body d={d} ({CHUNK:,} rows, {m:,} directions, plan {t['plan']}): "
            f"bit-identical {bits}; device {t['device_ms']:.5f} ms vs dirs @ P.T + max/min "
            f"{t['library_device_ms']:.5f} ms (in turns {[round(x, 5) for x in t['turns_device_ms']]}); "
            f"events {t['ms']:.5f} vs {t['library_ms']:.5f} ms; plain {t['plain_ms']:.3f} ms; "
            f"bound {t['bound_ms']:.5f} ms ({t['bound_by']}), {t['bound_ms'] / t['device_ms']:.3f} "
            f"of it")

    # its own path: the hull API on feature rows (d = 70)
    X = feats[70]
    normals = H.hull_normals(1600, 70, torch.Generator().manual_seed(18))
    reset_counts()
    t0 = time.perf_counter()
    ids = H.epsilon_kernel_indices(X, 400, normals=normals, device=dev)
    eps_s = time.perf_counter() - t0
    greedy = H.greedy_hull_projection(X, X.mean(0), 1e-2, 64, device=dev)
    _sync()
    census = read_counts()
    real = H.directional_extremes
    H.directional_extremes = directional_extremes_ref
    try:
        plain_ids = H.epsilon_kernel_indices(X, 400, normals=normals, device=dev)
        plain_greedy = H.greedy_hull_projection(X, X.mean(0), 1e-2, 64, device=dev)
    finally:
        H.directional_extremes = real
    rec["hull_api_d70"] = {
        "ids": int(ids.size), "same_ids": bool((ids == plain_ids).all()),
        "same_support": bool(torch.equal(greedy[1], plain_greedy[1])),
        "t_max_abs_err": float((greedy[0] - plain_greedy[0]).abs().max()),
        "epsilon_kernel_s": eps_s, "launches": census}
    log(f"  hull API at d = 70 (ε-kernel k = 400, greedy 64 steps): {json.dumps(rec['hull_api_d70'])}")
    if (not rec["hull_api_d70"]["same_ids"] or not rec["hull_api_d70"]["same_support"]
            or rec["hull_api_d70"]["t_max_abs_err"] > 1e-6 or ids.size != 400):
        errs.append(f"the hull API at d = 70 differs from its plain version: {rec['hull_api_d70']}")
    if census["extremes_wide"] != 65:
        errs.append(f"the hull API at d = 70 launched the wide body {census['extremes_wide']} "
                    "times, expected 65")
    if errs:
        fail("wide extremes: " + "; ".join(errs))
    return row, rec


def kernels_per_call(fn, errs, name, want, calls=20):
    """Device kernels a call of ``fn`` launches (torch.profiler)."""
    n = clean_window(fn, calls)["device_launches"] / calls
    if n != want:
        errs.append(f"{name} ran {n} device kernels a call, expected {want}")
    return n


def check_sweep(tag, SX0, X, P, sw, rows, signs, dirs, omega, n_valid, mom, errs) -> float:
    """One sweep call on the card against its plain version: SX' to the bit
    and z within 1e-6 (to the bit, but for the double rounding of the plain
    version's float64 emulation of each fma) against the plain version on the
    CPU; the extremes to the bit against the plain version on the card;
    the moments within rtol 1e-6 / atol 1e-4 of float64; the same bits on a
    repeated call. Returns the largest absolute error."""
    import torch

    from repro_torch.kernels.sweep.ops import fused_sweep_update
    from repro_torch.kernels.sweep.ref import fused_sweep_ref

    kw = dict(dirs=dirs, omega=omega, n_valid=n_valid, moments=mom)
    got = fused_sweep_update(SX0, X, P, sw, rows, signs, **kw)
    again = fused_sweep_update(SX0, X, P, sw, rows, signs, **kw)
    cpu = [t.to(X.device) for t in fused_sweep_ref(
        SX0.cpu(), X.cpu(), None, sw.cpu(), rows.cpu(), signs.cpu(),
        omega=None if omega is None else omega.cpu())[:2]]
    ext = fused_sweep_ref(SX0, X, P, sw, rows, signs, dirs=dirs, n_valid=n_valid,
                          want_z=False)[2]
    torch.cuda.synchronize()
    sx_bits, z_bits = same_bits(got[0], cpu[0]), same_bits(got[1], cpu[1])
    z_diff = int((got[1].view(torch.int32) != cpu[1].view(torch.int32)).sum())
    e = max(max_err(got[0], cpu[0]), max_err(got[1], cpu[1]))
    ok = sx_bits and close(got[1], cpu[1], rtol=1e-6, atol=1e-6)
    mism = int((got[2][1] != ext[1]).sum()) + int((got[2][3] != ext[3]).sum())
    ext_bits = all(same_bits(a, b) for a, b in zip(got[2], ext))
    if mom is not None:
        r64 = fused_sweep_ref(SX0.double(), X.double(), P.double(), sw.double(), rows,
                              signs.double(), moments=tuple(t.double() for t in mom),
                              want_z=False)[3]
        for g, rr in zip(got[3], r64):
            ok = ok and close(g, rr, rtol=1e-6, atol=1e-4)
            e = max(e, max_err(g, rr))
    flat = lambda o: [o[0], o[1], *o[2], *(o[3] or ())]  # noqa: E731
    stable = all(same_bits(a, b) for a, b in zip(flat(got), flat(again)))
    log(f"  sweep {tag}: SX' bit-identical {sx_bits}, z bit-identical {z_bits} ({z_diff} "
        f"elements differ), extremes bit-identical {ext_bits} ({mism} index mismatches), "
        f"same bits on repeat {stable}, max err {e:.3e}")
    if not (ok and ext_bits and stable):
        errs.append(f"sweep {tag} disagrees: SX' bits {sx_bits}, extremes bits {ext_bits}, "
                    f"repeat {stable}, err {e}")
    return e


# ---------------------------------------------------------------- phase 3


def mctm_kernel_modules() -> dict:
    """The MCTM kernels' ops modules, each holding its launch count."""
    from repro_torch.kernels.bernstein import ops as bern
    from repro_torch.kernels.extremes import ops as ext
    from repro_torch.kernels.gram import ops as gram
    from repro_torch.kernels.sweep import ops as sweep

    return {"bernstein": bern, "gram": gram, "extremes": ext, "sweep": sweep}


def reset_counts() -> None:
    for mod in mctm_kernel_modules().values():
        mod.LAUNCHES = 0
        for k in getattr(mod, "PATH_LAUNCHES", {}):
            mod.PATH_LAUNCHES[k] = 0


def read_counts() -> dict:
    """Each MCTM kernel's launches since ``reset_counts``, gram's cluster
    body's as ``gram_cluster`` and its large body's as ``gram_large``, the
    extremes kernel's wide body's as ``extremes_wide`` and the sweep's at
    D > 160 as ``sweep_wide``."""
    mods = mctm_kernel_modules()
    out = {k: mod.LAUNCHES for k, mod in mods.items()}
    out["gram_cluster"] = mods["gram"].PATH_LAUNCHES["cluster"]
    out["gram_large"] = mods["gram"].PATH_LAUNCHES["large"]
    out["extremes_wide"] = mods["extremes"].PATH_LAUNCHES["wide"]
    out["sweep_wide"] = mods["sweep"].PATH_LAUNCHES["wide"]
    return out


def lookup_featurizer(X, P, where, dtype=None):
    """A featurize that returns rows of the fixed features (X (n, D), P (n·r,
    d)) for the point indices in column 0 of its input, so engines on the
    card and the CPU score identical features; ``dtype`` first rounds them
    to that type (a control)."""
    import torch

    r = P.shape[0] // X.shape[0]
    Xt, Pt = ((t if dtype is None else t.to(dtype).float()).to(where) for t in (X, P))

    def featurize(Yc):
        idx = Yc[:, 0].long()
        return Xt[idx], Pt[(r * idx[:, None] + torch.arange(r, device=idx.device)).reshape(-1)]

    return featurize


def phase_path(dev):
    """The Algorithm 1 path, both strategies; returns launches per kernel
    and the two-pass run's full-fit parameters (phase 6 samples from them).
    Two-pass takes the driver's default full-data fit (the streaming lbfgs),
    one-pass an adam full-data fit, so both fit methods run at full size;
    each full fit's time, steps, lbfgs sweeps and bernstein launches are
    read around the driver's own calls of ``fit_mctm_streaming``."""
    from repro_torch.core import mctm_fit
    from repro_torch.launch import train_mctm

    import torch

    mods = mctm_kernel_modules()
    bern = mods["bernstein"]
    need = {"two-pass": ("bernstein", "gram", "extremes"), "one-pass": ("bernstein", "sweep")}
    total = dict.fromkeys(mods, 0)
    fits, full_params = [], []
    real_fit = train_mctm.fit_mctm_streaming

    def counted_fit(*args, **kwargs):
        b0, t0 = bern.LAUNCHES, time.perf_counter()
        out = real_fit(*args, **kwargs)
        torch.cuda.synchronize()
        rec = {"method": kwargs.get("method"), "weighted": kwargs.get("weights") is not None,
               "s": time.perf_counter() - t0, "steps": int(out.losses.size),
               "bernstein_launches": bern.LAUNCHES - b0, "final_nll": out.final_nll}
        if rec["method"] == "lbfgs":
            rec["lbfgs_sweeps"] = dict(mctm_fit.LAST_LBFGS_SWEEPS)
            full_params.append(out.params)
        fits.append(rec)
        return out

    train_mctm.fit_mctm_streaming = counted_fit
    try:
        for strategy in ("two-pass", "one-pass"):
            argv = [
                "--device", "cuda", "--dgp", "normal_mixture", "--n", str(MAIN_N), "--seed", "0",
                "--degree", "6", "--chunk", str(CHUNK), "--alpha", "0.8",
                "--ks", ",".join(map(str, KS)), "--steps", "250", "--lr", "0.05",
                "--fit-method", "adam", "--strategy", strategy,
            ]
            if strategy == "one-pass":
                argv += ["--ref-method", "adam", "--sketch-size", str(SKETCH)]
            reset_counts()
            del fits[:]
            rec = train_mctm.main(argv)  # exits nonzero when a ratio leaves its band
            counts = read_counts()
            full = fits[0]
            log(f"path {strategy}: full fit ({rec['ref_method']}) {rec['full_fit_s']:.3f}s  "
                f"NLL/pt {rec['full_nll_per_point']:.5f}  launches {counts}")
            log(f"  {strategy} full fit: " + json.dumps(full))
            if full["method"] != rec["ref_method"] or full["bernstein_launches"] <= 0:
                fail(f"the {strategy} full-data fit ({full['method']}) launched bernstein "
                     f"{full['bernstein_launches']} times")
            if strategy == "two-pass" and (rec["ref_method"] != "lbfgs"
                                           or full["lbfgs_sweeps"]["iters"] <= 0):
                fail(f"the two-pass full-data fit is not the driver's lbfgs: {full}")
            for r in rec["per_k"]:
                log(f"  {strategy} k={r['k']}: build_s {r['build_s']:.4f} fit_s {r['fit_s']:.4f} "
                    f"eps_hat {r['eps_hat']:.5f} ratio {r['ratio']:.5f} "
                    f"band [{r['band'][0]:.4f}, {r['band'][1]:.4f}] within_band {r['within_band']}")
            for name in need[strategy]:
                if counts[name] == 0:
                    fail(f"{name} was not launched on the {strategy} path")
            for k in total:
                total[k] += counts[k]
    finally:
        train_mctm.fit_mctm_streaming = real_fit
    return total, full_params[0]


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
    # adam 30 steps; lbfgs to gtol 1e-5 (both sides converge to the same
    # optimum: the line searches may accept other steps on the way)
    for method, kw in (("adam", {"steps": 30}), ("lbfgs", {"steps": 100, "gtol": 1e-5})):
        fits = {}
        for where in ("cpu", "cuda"):
            init = M.init_params(cfg, normals=np.zeros((cfg.J, cfg.d), np.float32), device=where)
            fits[where] = fit_mctm_streaming(cfg, scaler, Yn[idx], weights=w, init=init,
                                             method=method, chunk_size=100, device=where, **kw)
        a, b = fits["cuda"].final_nll, fits["cpu"].final_nll
        if not np.isfinite(a) or abs(a - b) > 1e-4 * abs(b):
            fail(f"{method} fit on the card disagrees with the CPU path: {a} vs {b}")
        log(f"small input {method} fit: final NLL {a:.6f} (card) vs {b:.6f} (CPU), rel "
            f"{abs(a - b) / abs(b):.2e}")


WIDE_SCORING_N = 50_000   # table2_covertype.py's n at J = 10
# ridge-lss scores at J = 10 and n = 50,000: the CPU path itself lies 1.06e-4
# from the float64 scores of the same features (the f32 Gram over 50,000
# rows, measured on the CPU with this data), so card and CPU are held to
# 2e-4 of each other and of float64. tests/test_torch_scoring.py's 2e-5 is for
# n ≤ 3,001, where the same check on the card passes
# (tests/test_torch_cuda.py). Two lower-precision controls run through the
# same check and must fail it: a TF32 Gram, and features rounded to bf16.
WIDE_SCORING_RTOL = 2e-4
# each side's own featurize: the least share of hull points in common. The
# card's bernstein bits differ from the plain version's in the last bit, and
# the extreme rows of a direction lie within 1e-6 of each other here, so the
# argmax moves between near-ties (112 and 104 of 154 in common, two-pass and
# one-pass, NVIDIA H100 80GB HBM3); both sides give the same bits on every
# run, and the floor catches a hull that goes wrong wholesale.
WIDE_HULL_COMMON_FLOOR = 0.6


def _tf32_gram(X, sw=None, *, acc=None, backend=None):
    """acc + (√w·X)ᵀ(√w·X) by torch.mm with TF32 allowed: the control that
    WIDE_SCORING_RTOL must reject."""
    import torch

    Xw = X if sw is None else X * sw[:, None]
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        G = Xw.T @ Xw
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return G if acc is None else acc + G


def phase_wide_scoring(dev):
    """The port's scoring at J = 10 (D = 70) on covertype, n = 50,000 at
    degree 6 as table2_covertype.py, on the card against its CPU path, both
    strategies (one-pass at the default sketch 4·D² = 19,600), in the two
    layers of tests/test_torch_scoring.py:

    - identical features (both engines read the CPU featurize's bits through
      a lookup) and one direction net (two-pass: from those features'
      moments; one-pass: the same generator): the same hull rows, and
      ridge-lss scores within WIDE_SCORING_RTOL of the CPU path's and, for
      the exact two-pass Gram, of float64's;
    - each side's own featurize: scores within WIDE_SCORING_RTOL of each
      other and, two-pass, of the float64 scores of that side's own features
      (the card's featurize differs from the CPU's in the last bits), and at
      least WIDE_HULL_COMMON_FLOOR of the hull points in common;
    - a second covertype draw (seed 1), two-pass on own featurize: the card
      within WIDE_SCORING_RTOL of float64 of its features; card vs CPU and
      the hull overlap reported.

    The tiled body's launch count is read after the first two layers, the
    path's runs. Then the controls: the two-pass card run on identical features once with
    its Gram taken in TF32 (``_tf32_gram`` in place of the gram kernel), once
    with the features rounded to bf16; each must lie beyond
    WIDE_SCORING_RTOL of the CPU path or of float64, so the limit is shown
    to separate a lower-precision card path."""
    import numpy as np
    import torch

    from repro_torch.core import mctm as M
    from repro_torch.core import scoring
    from repro_torch.core.bernstein import DataScaler
    from repro_torch.core.scoring import ScoringEngine, _mctm_featurize, directions_from_moments
    from repro_torch.data import generate_covertype
    from repro_torch.kernels.gram import ops as gram

    n, J = WIDE_SCORING_N, 10
    cfg = M.MCTMConfig(J=J, degree=6)

    def ridge_float64(Xf):
        """The exact two-pass ridge-lss scores of features Xf, in float64."""
        Xd = Xf.double().cpu().numpy()
        return np.einsum("ij,jk,ik->i", Xd, np.linalg.inv(Xd.T @ Xd + np.eye(Xd.shape[1])),
                         Xd) + 1.0 / n

    def covertype(seed):
        """Y, its scaler, the CPU featurize's (X, P), the float64 scores of the
        CPU's and of the card's features, and a direction net from P."""
        Y = generate_covertype(n, seed=seed).astype(np.float32)
        scaler = DataScaler.fit(Y)
        X, P = _mctm_featurize(cfg, scaler)(torch.as_tensor(Y))
        Xc = _mctm_featurize(cfg, scaler)(torch.as_tensor(Y).to(dev))[0]
        Pd = P.double().numpy()
        net = directions_from_moments(Pd.sum(0), Pd.T @ Pd, Pd.shape[0], 40,
                                      generator=torch.Generator().manual_seed(3))
        return Y, scaler, X, P, ridge_float64(X), ridge_float64(Xc), net

    Y, scaler, X, P, exact, exact_card, net = covertype(0)
    Yidx = np.stack([np.arange(n), np.zeros(n)], axis=1).astype(np.float32)

    def score(where, layer, kw, dtype=None, data=None):
        if layer == "identical features":
            eng = ScoringEngine(featurize=lookup_featurizer(X, P, where, dtype), rows_per_point=J,
                                chunk_size=CHUNK, device=where)
            Yw = Yidx
        else:
            Yw, sc = (Y, scaler) if data is None else data
            eng = ScoringEngine(cfg, sc, chunk_size=CHUNK, device=where)
        return eng.score(Yw, method="ridge-lss", hull_k=40,
                         generator=torch.Generator().manual_seed(3), **kw)

    def rel(a, b):
        return float(np.max(np.abs(a - b) / np.abs(b)))

    out, two_pass_cpu = {}, None
    gram.PATH_LAUNCHES["tiled"] = 0  # the tiled body's launches over the path's card runs
    for name, kw in (("two-pass", {"hull_dirs": net}), ("one-pass", {"sketch_size": 4 * 70 * 70})):
        for layer in ("identical features", "own featurize"):
            res, secs = {}, {}
            for where in ("cpu", "cuda"):
                t0 = time.perf_counter()
                res[where] = score(where, layer, kw)
                secs[where] = time.perf_counter() - t0
            a, b = res["cuda"], res["cpu"]
            common = np.intersect1d(a.hull_points, b.hull_points).size
            rec = {"max_score_rel_err": rel(a.scores, b.scores), "hull_points_common": int(common),
                   "hull_points": int(b.hull_points.size),
                   "hull_rows_equal": bool(np.array_equal(a.hull_rows, b.hull_rows)),
                   "card_s": secs["cuda"], "cpu_s": secs["cpu"]}
            worst = rec["max_score_rel_err"]
            if name == "two-pass":  # the exact Gram: each side against float64 of its features
                own = layer == "own featurize"
                if not own:
                    two_pass_cpu = b.scores
                rec["card_vs_float64"] = rel(a.scores, exact_card if own else exact)
                rec["cpu_vs_float64"] = rel(b.scores, exact)
                worst = max(worst, rec["card_vs_float64"], rec["cpu_vs_float64"])
            out[f"{name}, {layer}"] = rec
            log(f"J=10 covertype n={n:,} {name}, {layer}: " + json.dumps(rec))
            ok = (a.scores.shape == (n,) and bool(np.all(np.isfinite(a.scores)))
                  and worst <= WIDE_SCORING_RTOL)
            if layer == "identical features":
                ok = ok and rec["hull_rows_equal"]
            else:
                ok = ok and common >= WIDE_HULL_COMMON_FLOOR * rec["hull_points"]
            if not ok:
                fail(f"J=10 scoring on the card disagrees with the CPU path ({name}, {layer})")

    out["gram_tiled_launches"] = gram.PATH_LAUNCHES["tiled"]
    log(f"J=10 covertype n={n:,}: gram's tiled body launched {out['gram_tiled_launches']} times "
        "over the path's card runs")
    if out["gram_tiled_launches"] <= 0:
        fail("gram's tiled body was not launched on the J = 10 scoring path")

    # a second covertype draw, two-pass on each side's own featurize: the
    # card held to float64 of its own features; card vs CPU and the hull
    # overlap reported
    Y1, scaler1, _, _, exact1, exact1_card, net1 = covertype(1)
    res = {where: score(where, "own featurize", {"hull_dirs": net1}, data=(Y1, scaler1))
           for where in ("cpu", "cuda")}
    a, b = res["cuda"], res["cpu"]
    rec = {"max_score_rel_err": rel(a.scores, b.scores),
           "card_vs_float64": rel(a.scores, exact1_card), "cpu_vs_float64": rel(b.scores, exact1),
           "hull_points_common": int(np.intersect1d(a.hull_points, b.hull_points).size),
           "hull_points": int(b.hull_points.size)}
    out["two-pass, own featurize, seed 1"] = rec
    log(f"J=10 covertype n={n:,} seed 1 two-pass, own featurize: " + json.dumps(rec))
    if (a.scores.shape != (n,) or not np.all(np.isfinite(a.scores))
            or rec["card_vs_float64"] > WIDE_SCORING_RTOL):
        fail(f"J=10 scoring on the card lies beyond {WIDE_SCORING_RTOL} of float64 (seed 1)")

    gram_kernel = scoring.gram_matrix
    for control in ("TF32 Gram", "bf16 features"):
        scoring.gram_matrix = _tf32_gram if control == "TF32 Gram" else gram_kernel
        try:
            a = score("cuda", "identical features", {"hull_dirs": net},
                      torch.bfloat16 if control == "bf16 features" else None)
        finally:
            scoring.gram_matrix = gram_kernel
        rec = {"card_vs_cpu": rel(a.scores, two_pass_cpu), "card_vs_float64": rel(a.scores, exact)}
        rec["over_limit"] = max(rec.values()) / WIDE_SCORING_RTOL
        out[f"control, two-pass, {control}"] = rec
        log(f"J=10 covertype n={n:,} control, two-pass, {control}: " + json.dumps(rec))
        if rec["over_limit"] <= 1.0:
            fail(f"WIDE_SCORING_RTOL does not separate the {control} control: {rec}")
    return out


# ---------------------------------------------------------------- phase 6

# the conditional model of tests/test_conditional.py: F = 2 features, the
# linear shift β, ε correlated at 0.6; at J = 2, degree 6 the leverage rows
# (b_i, x_i) have D = dJ + F = 16, and the one-pass sketch is 4·D²
COND_F = 2
COND_BETA = ((1.5, -0.5), (0.3, 0.8))
COND_SKETCH = 4 * 16 ** 2
COND_SMALL_N = 4000            # the reference test's fixture
# the 4,000-point fixture's l2-only scores, each side against float64 of its
# own features: the CPU path reads 4.28e-4, the card 3.30e-4 (identical
# features) and 3.14e-4 (own featurize), 1.9× and 2.4× inside the limit;
# the TF32-Gram control reads 1.26e-3, 1.6× beyond it (NVIDIA H100 80GB
# HBM3, PERF.md §6). Card vs CPU is held to twice the limit (two f32 sums,
# each within it; 4.1e-4 measured)
COND_SCORE_RTOL = 8e-4
# the build's hull points in common, card vs CPU on the same plans: the
# card's bernstein bits differ from the plain version's in the last bit and
# the argmax moves between near-ties (38 of 40 here; 35 of 40 on the card
# test's fixture)
COND_HULL_COMMON_FLOOR = 0.8
FIT_RTOL = 1e-4                # phase 3's card-vs-CPU fit gate
TABLE1_N, TABLE1_STEPS, TABLE1_KS = 10_000, 700, (30, 100)   # benchmarks/table1_dgp.py
TABLE1_METHODS = ("l2-hull", "l2-only", "uniform", "ridge-lss", "root-l2")
# evaluate_coreset card vs CPU (l2-hull, k = 100, the same plans and start):
# the hull tail follows each side's own featurize and the weights each
# side's scores, so the 700-step refits differ a little: measured 1.1e-3
# (param ℓ2, relative), 3.2e-2 (λ error, relative) and 6.6e-6 (likelihood
# ratio, absolute), 9×, 3× and 15× inside the limits
TABLE1_GATE = {"param_l2": 1e-2, "lambda_err": 1e-1, "likelihood_ratio": 1e-4}
# the standalone leverage API at (250,001, 14): each variant's largest
# relative error against float64 of the same X (max |u − u64| / u64), held to
# LEVERAGE_RTOL and beside a control that the limit must reject: gram, ridge
# and root with their Gram in TF32 (``_tf32_gram`` in place of the gram
# kernel), qr and the sketch with X rounded to bf16 (the sketch then sums
# bf16 rows). Read on an NVIDIA H100 80GB HBM3 (PERF.md §6), each limit's
# margin inside / the control's over it: qr 1.52e-3 (3.3×) / 1.43 (285×),
# gram 3.52e-3 (2.8×) / 1.07e-1 (10.7×), ridge 1.24e-4 (8.1×) / 8.40e-3
# (8.4×), root 1.76e-3 (5.7×) / 5.52e-2 (5.5×), sketched 1.22e-2 (4.1×) /
# 1.36 (27×); the l2 forms' pseudo-inverse is ill conditioned (ROADMAP
# Queue C 2)
LEVERAGE_RTOL = {"qr": 5e-3, "gram": 1e-2, "ridge": 1e-3, "root": 1e-2, "sketched": 5e-2}
LEVERAGE_CONTROL = {"qr": "bf16 X", "gram": "TF32 Gram", "ridge": "TF32 Gram",
                    "root": "TF32 Gram", "sketched": "bf16 X"}
SAMPLE_SPAN_ATOL = 1e-5        # sample card vs CPU, share of the scaler's span (1.8e-7 measured)
# float64 two-pass scores card vs CPU on identical features: 3.5e-7 measured,
# far inside Queue C 2's 3e-3 (float32 against float64 reads 3.0e-3)
F64_SCORE_RTOL = 1e-5


def conditional_data(n: int, seed: int = 0):
    """tests/test_conditional.py's generator at n points: (Y (n, 2), X (n, F))."""
    import numpy as np

    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, COND_F))
    eps = rng.standard_normal((n, 2)) @ np.linalg.cholesky(np.array([[1, 0.6], [0.6, 1]])).T
    Y = X @ np.array(COND_BETA).T + eps
    return Y.astype(np.float32), X.astype(np.float32)


def l2_float64(F) -> "np.ndarray":
    """Exact l2-only scores of features F in float64: the pseudo-inverse with
    the engine's rcond 1e-6 of max|w|, plus 1/n."""
    import numpy as np

    Xd = F.double().cpu().numpy()
    w, V = np.linalg.eigh(Xd.T @ Xd)
    inv = np.where(w > 1e-6 * np.abs(w).max(), 1.0 / np.maximum(w, 1e-30), 0.0)
    return np.einsum("ij,j->i", (Xd @ V) ** 2, inv) + 1.0 / Xd.shape[0]


def rel_err(a, b) -> float:
    import numpy as np

    return float(np.max(np.abs(np.asarray(a) - np.asarray(b)) / np.abs(np.asarray(b))))


def phase_core(dev, two_pass_params, kernels_at_d16):
    """Phase 6: the paper's core beyond Algorithm 1's path, with the kernel
    times ``phase_kernels_d16`` took earlier. Returns (census of each new
    path's kernel launches, records)."""
    errs: list[str] = []
    census: dict = {}
    rec: dict = {"kernels_at_d16": kernels_at_d16}
    rec["conditional"] = _core_conditional(dev, census, errs)
    rec["conditional_small"] = _core_conditional_small(dev, errs)
    rec["table1"] = _core_table1(dev, census, errs)
    rec["standalone"] = _core_standalone(dev, census, errs, two_pass_params)
    need = {
        "conditional full fit (adam)": ("bernstein",),
        "conditional two-pass": ("bernstein", "gram", "gram_cluster", "extremes"),
        "conditional one-pass": ("bernstein", "sweep"),
        "table 1 (evaluate_coreset)": ("bernstein", "gram", "extremes"),
        "standalone leverage": ("gram", "sweep"),
        "epsilon_kernel_indices": ("extremes",),
        "greedy_hull_projection (m = 1)": ("extremes",),
    }
    for path, names in need.items():
        counts = census.get(path, {})
        log(f"census {path}: {json.dumps(counts)}")
        for name in names:
            if counts.get(name, 0) <= 0:
                errs.append(f"{name} was not launched on the {path} path")
    if errs:
        fail("phase 6: " + "; ".join(errs))
    return census, rec


def _sync():
    import torch

    torch.cuda.synchronize()


def phase_kernels_d16(dev) -> dict:
    """Phase 6's kernels at the conditional width, run beside phase 2 (the
    profiler windows after phase 4's serve profiles drop and gain kernel
    records): gram (cluster body) and the sweep on one 16,384-point chunk of
    rows (b_i, x_i), D = 16, r = 2; gram against float64 and in turns with
    torch.mm, the sweep at the one-pass sketch 4·D² = 1,024 against k =
    2000's upfront net (1,614 directions) held to its plain version
    (``check_sweep``) from a nonzero carry, each beside its bound."""
    import numpy as np
    import torch

    from repro_torch.core import conditional as C
    from repro_torch.core.bernstein import DataScaler
    from repro_torch.core.scoring import sketch_plan, upfront_directions
    from repro_torch.kernels.gram import gram_matrix
    from repro_torch.kernels.gram.ref import gram_ref
    from repro_torch.kernels.sweep import fused_sweep_update

    errs: list[str] = []
    cfg = C.CMCTMConfig(J=2, n_features=COND_F, degree=6)
    Y, X = conditional_data(CHUNK)
    YX = torch.as_tensor(np.concatenate([Y, X], axis=1), device=dev)
    F, P = C._conditional_featurize(cfg, DataScaler.fit(Y))(YX)
    D, d = F.shape[1], P.shape[1]
    gen = torch.Generator().manual_seed(12)
    sw = torch.ones(CHUNK, device=dev)
    G0 = torch.randn((D, D), generator=gen).to(dev)
    G = gram_matrix(F, sw, acc=G0)
    Gr = gram_ref(F.double(), sw.double(), acc=G0.double())
    err = max_err(G, Gr)
    if err > 1e-5 * float(Gr.abs().max()):
        errs.append(f"gram D={D} lies {err} from float64")
    t = in_turns(lambda: gram_matrix(F, sw, acc=G0), lambda: torch.mm(F.T, F))
    b, by = bound_ms(4 * (CHUNK * D + CHUNK + 2 * D * D), CHUNK * (D + D * (D + 1)))
    out = {"gram_D16": dict(t, bound_ms=b, bound_by=by, max_abs_err=err)}
    log(f"gram ({CHUNK:,}, {D}) cluster body: max abs err {err:.3e} of max|G| "
        f"{float(Gr.abs().max()):.3e}; device {t['device_ms']:.5f} ms vs torch.mm "
        f"{t['library_device_ms']:.5f} ms (ratio {t['device_ratio']:.3f}, in turns "
        f"{[round(x, 5) for x in t['turns_device_ms']]}); events {t['ms']:.5f} vs "
        f"{t['library_ms']:.5f} ms; bound {b:.5f} ms ({by}), {b / t['device_ms']:.3f} of it")
    up = torch.as_tensor(upfront_directions(d, 400, generator=gen), device=dev)
    rows, signs = sketch_plan(CHUNK, COND_SKETCH, generator=gen, device=dev)
    SX0 = torch.randn((COND_SKETCH, D), generator=gen).to(dev)
    mom = (torch.zeros(d, device=dev), torch.zeros((d, d), device=dev))
    tag = f"({CHUNK:,}, {D}) r=2 sketch={COND_SKETCH:,} m={up.shape[0]}"
    out_err = check_sweep(tag, SX0, F, P, sw, rows, signs, up, None, CHUNK, mom, errs)
    call = lambda: fused_sweep_update(SX0, F, P, sw, rows, signs, dirs=up)  # noqa: E731
    dms, ems = device_ms(call), cuda_ms(call)
    mu = up.shape[0]
    b, by = bound_ms(4 * (2 * CHUNK * D + P.numel() + 3 * CHUNK + up.numel()
                          + 2 * COND_SKETCH * D + 4 * mu), CHUNK * 2 * D + 2 * mu * P.shape[0] * d)
    out["sweep_D16"] = {"device_ms": dms, "ms": ems, "bound_ms": b, "bound_by": by,
                        "sketch": COND_SKETCH, "directions": mu, "max_abs_err": out_err}
    log(f"sweep {tag}: device {dms:.5f} ms, events {ems:.5f} ms, bound {b:.5f} ms ({by}), "
        f"{b / dms:.3f} of it")
    if errs:
        fail("phase 6 kernels at D 16: " + "; ".join(errs))
    return out


def _core_conditional(dev, census, errs) -> dict:
    """Conditional Algorithm 1 at n = 250,001 (J = 2, degree 6, F = 2): the
    adam full fit, then both builds at each k with an adam coreset fit."""
    import numpy as np
    import torch

    from repro_torch.core import conditional as C
    from repro_torch.core.bernstein import DataScaler

    cfg = C.CMCTMConfig(J=2, n_features=COND_F, degree=6)
    Y, X = conditional_data(MAIN_N)
    scaler = DataScaler.fit(Y)
    model = C.CMCTMDensityModel(cfg, scaler)
    YX = torch.as_tensor(np.concatenate([Y, X], axis=1), device=dev)

    def cnll_full(params) -> float:
        total = 0.0
        with torch.no_grad():
            for lo in range(0, MAIN_N, CHUNK):
                total += float(C.cnll(cfg, params, *model.features({"YX": YX[lo:lo + CHUNK]})))
        return total

    out = {"n": MAIN_N, "D": cfg.J * cfg.d + COND_F, "per_k": []}
    reset_counts()
    t0 = time.perf_counter()
    full = C.fit_cmctm(cfg, scaler, Y, X, steps=250, lr=0.05, chunk_size=CHUNK,
                       generator=torch.Generator().manual_seed(0), device=dev)
    _sync()
    out["full_fit_s"] = time.perf_counter() - t0
    census["conditional full fit (adam)"] = read_counts()
    nll_full = cnll_full(full.params)
    beta = full.params.beta.cpu().numpy()
    out["full_cnll_per_point"] = nll_full / MAIN_N
    out["beta_row0"] = beta[0].tolist()
    out["beta_row0_corr"] = float(np.corrcoef(beta[0], np.array(COND_BETA)[0])[0, 1])
    log(f"conditional n={MAIN_N:,} D={out['D']}: full fit (adam, 250 steps) "
        f"{out['full_fit_s']:.3f}s, cNLL/pt {out['full_cnll_per_point']:.5f}, β row 0 "
        f"{[round(b, 4) for b in beta[0]]} (corr {out['beta_row0_corr']:.4f} with the true row)")
    if not (np.isfinite(nll_full) and abs(out["beta_row0_corr"]) > 0.9):
        errs.append(f"the conditional full fit missed the shift: {out['beta_row0_corr']}")
    for strategy, sketch in (("two-pass", 0), ("one-pass", COND_SKETCH)):
        reset_counts()
        for k in KS:
            k1 = int(np.floor(0.8 * k))
            t0 = time.perf_counter()
            idx, w = C.build_conditional_coreset(
                cfg, scaler, Y, X, k, generator=torch.Generator().manual_seed(k), alpha=0.8,
                chunk_size=CHUNK, sketch_size=sketch, device=dev)
            _sync()
            build_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            cs = C.fit_cmctm(cfg, scaler, Y[idx], X[idx], weights=w, steps=250, lr=0.05,
                             chunk_size=CHUNK, generator=torch.Generator().manual_seed(1),
                             device=dev)
            _sync()
            fit_s = time.perf_counter() - t0
            nll_cs = cnll_full(cs.params)
            r = {"strategy": strategy, "k": k, "build_s": build_s, "fit_s": fit_s,
                 "full_fit_s": out["full_fit_s"], "cnll_ratio": nll_cs / nll_full,
                 "cnll_cs_per_point": nll_cs / MAIN_N, "ids": int(idx.size),
                 "hull_ids_distinct": len(set(idx[k1:].tolist()))}
            out["per_k"].append(r)
            log(f"  conditional {strategy} k={k}: build_s {build_s:.4f} fit_s {fit_s:.4f} "
                f"full_fit_s {out['full_fit_s']:.3f} cNLL/pt {r['cnll_cs_per_point']:.5f} "
                f"ratio {r['cnll_ratio']:.5f}")
            if (idx.shape != (k,) or r["hull_ids_distinct"] != k - k1 or not np.all(w > 0)
                    or not nll_cs <= nll_full + 0.1 * abs(nll_full)):
                errs.append(f"conditional {strategy} k={k} failed its gates: {r}")
        census[f"conditional {strategy}"] = read_counts()
    return out


def _core_conditional_small(dev, errs) -> dict:
    """The 4,000-point fixture, card against CPU: l2-only scores on identical
    features and on each side's own featurize, each side against float64 of
    its own features, with a TF32-Gram control; the hull overlap of the
    build on the same plans; adam and lbfgs fits."""
    import numpy as np
    import torch

    from repro_torch.core import conditional as C
    from repro_torch.core import scoring
    from repro_torch.core.bernstein import DataScaler
    from repro_torch.core.hull import hull_normals
    from repro_torch.core.scoring import ScoringEngine

    n = COND_SMALL_N
    cfg = C.CMCTMConfig(J=2, n_features=COND_F, degree=6)
    Y, X = conditional_data(n)
    scaler = DataScaler.fit(Y)
    YX = np.concatenate([Y, X], axis=1)
    feat = C._conditional_featurize(cfg, scaler)
    F_cpu, P_cpu = feat(torch.as_tensor(YX))
    F_card = feat(torch.as_tensor(YX, device=dev))[0]
    exact_cpu, exact_card = l2_float64(F_cpu), l2_float64(F_card)
    Yidx = np.stack([np.arange(n), np.zeros(n)], axis=1).astype(np.float32)

    def scores(where, layer):
        if layer == "identical features":
            eng = ScoringEngine(featurize=lookup_featurizer(F_cpu, P_cpu, where), rows_per_point=2,
                                chunk_size=CHUNK, device=where)
            return eng.score(Yidx, method="l2-only").scores
        return C.conditional_coreset_scores(cfg, scaler, Y, X, chunk_size=CHUNK, device=where)

    out = {}
    for layer in ("identical features", "own featurize"):
        a, b = scores(dev, layer), scores("cpu", layer)
        own = layer == "own featurize"
        r = {"card_vs_cpu": rel_err(a, b),
             "card_vs_float64": rel_err(a, exact_card if own else exact_cpu),
             "cpu_vs_float64": rel_err(b, exact_cpu)}
        out[layer] = r
        log(f"conditional n={n:,} scores, {layer}: " + json.dumps(r))
        if (r["card_vs_float64"] > COND_SCORE_RTOL or r["cpu_vs_float64"] > COND_SCORE_RTOL
                or r["card_vs_cpu"] > 2 * COND_SCORE_RTOL or not np.all(np.isfinite(a))):
            errs.append(f"conditional scores, {layer}, beyond {COND_SCORE_RTOL}: {r}")
    gram_kernel = scoring.gram_matrix
    scoring.gram_matrix = _tf32_gram
    try:
        a = scores(dev, "identical features")
    finally:
        scoring.gram_matrix = gram_kernel
    r = {"card_vs_float64": rel_err(a, exact_cpu)}
    r["over_limit"] = r["card_vs_float64"] / COND_SCORE_RTOL
    out["control, TF32 Gram"] = r
    log(f"conditional n={n:,} control, TF32 Gram: " + json.dumps(r))
    if r["over_limit"] <= 1.0:
        errs.append(f"COND_SCORE_RTOL does not separate the TF32-Gram control: {r}")

    k, k1 = 200, 160
    gen = torch.Generator().manual_seed(11)
    probs = torch.as_tensor(exact_cpu / exact_cpu.sum())
    plans = {"draw": torch.multinomial(probs, k1, replacement=True, generator=gen).numpy(),
             "hull_normals": hull_normals(4 * (k - k1), cfg.d, gen)}
    built = {where: C.build_conditional_coreset(cfg, scaler, Y, X, k, chunk_size=CHUNK,
                                                device=where, **plans)
             for where in ("cpu", dev)}
    (ic, wc), (ig, wg) = built["cpu"], built[dev]
    common = int(np.intersect1d(ig[k1:], ic[k1:]).size)
    out["build"] = {"hull_points_common": common, "hull_points": k - k1,
                    "sampled_equal": bool(np.array_equal(ig[:k1], ic[:k1])),
                    "max_weight_rel_err": rel_err(wg, wc)}
    log(f"conditional n={n:,} build k={k}: " + json.dumps(out["build"]))
    if (not out["build"]["sampled_equal"] or common < COND_HULL_COMMON_FLOOR * (k - k1)
            or len(set(ig[k1:].tolist())) != k - k1):
        errs.append(f"the conditional build on the card disagrees with the CPU: {out['build']}")

    for method, kw in (("adam", {"steps": 60}), ("lbfgs", {"steps": 100, "gtol": 1e-5})):
        fits = {}
        for where in ("cpu", dev):
            init = C.init_cparams(cfg, normals=np.zeros((2, cfg.d), np.float32), device=where)
            fits[where] = C.fit_cmctm(cfg, scaler, Y, X, init=init, method=method,
                                      chunk_size=1000, device=where, **kw)
        a, b = fits[dev].final_nll, fits["cpu"].final_nll
        out[f"{method} fit"] = {"card": a, "cpu": b, "rel": abs(a - b) / abs(b),
                                "steps": int(fits[dev].losses.size)}
        log(f"conditional n={n:,} {method} fit: final cNLL {a:.6f} (card) vs {b:.6f} (CPU), "
            f"rel {abs(a - b) / abs(b):.2e}")
        if not np.isfinite(a) or abs(a - b) > FIT_RTOL * abs(b):
            errs.append(f"the conditional {method} fit on the card disagrees with the CPU")
    return out


def _core_table1(dev, census, errs) -> dict:
    """benchmarks/table1_dgp.py's workflow through evaluate_coreset on the
    card (normal_mixture, n = 10,000, J = 2, degree 6, adam fits of 700
    steps, one repetition), with Table 2's baselines; l2-hull at k = 100
    held against the CPU port on the same plans and start."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.core import mctm as M
    from repro_torch.core.bernstein import DataScaler
    from repro_torch.core.coreset import coreset_scores, evaluate_coreset
    from repro_torch.core.hull import hull_normals
    from repro_torch.data.dgp import generate

    cfg = M.MCTMConfig(J=2, degree=6)
    Y = generate("normal_mixture", TABLE1_N, seed=0).astype(np.float32)
    scaler = DataScaler.fit(Y)
    reset_counts()
    t0 = time.perf_counter()
    full = M.fit_mctm(cfg, scaler, Y, steps=TABLE1_STEPS,
                      generator=torch.Generator().manual_seed(0), device=dev)
    _sync()
    out = {"full_fit_s": time.perf_counter() - t0, "rows": []}
    for k in TABLE1_KS:
        for method in TABLE1_METHODS:
            ev = evaluate_coreset(cfg, scaler, Y, full, k, method,
                                  generator=torch.Generator().manual_seed(1000 * k),
                                  steps=TABLE1_STEPS, device=dev)
            r = {"method": method, "k": ev.k, "param_l2": ev.param_l2,
                 "lambda_err": ev.lambda_err, "likelihood_ratio": ev.likelihood_ratio,
                 "fit_s": ev.fit_seconds, "sample_s": ev.sample_seconds}
            out["rows"].append(r)
            log(f"table 1 normal_mixture k={k} {method}: param_l2 {ev.param_l2:.4f} "
                f"lambda_err {ev.lambda_err:.4f} LR {ev.likelihood_ratio:.5f} fit_s "
                f"{ev.fit_seconds:.3f} sample_s {ev.sample_seconds:.4f}")
            if ev.k != k or not all(np.isfinite(v) for v in (ev.param_l2, ev.lambda_err,
                                                               ev.likelihood_ratio)):
                errs.append(f"table 1 {method} k={k}: {r}")
    census["table 1 (evaluate_coreset)"] = read_counts()
    log(f"table 1: full fit (adam, {TABLE1_STEPS} steps) {out['full_fit_s']:.3f}s")

    k, k1 = 100, 80
    gen = torch.Generator().manual_seed(5)
    s = coreset_scores(cfg, scaler, Y, "l2-hull", device="cpu")
    plans = {"draw": torch.multinomial(torch.as_tensor(s / s.sum()), k1, replacement=True,
                                       generator=gen).numpy(),
             "hull_normals": hull_normals(4 * (k - k1), cfg.d, gen)}
    full_cpu = M.FitResult(params=M.params_from_numpy(*M.params_to_numpy(full.params),
                                                      device="cpu"),
                           losses=full.losses, final_nll=full.final_nll)
    evs = {}
    for where, ff in ((dev, full), ("cpu", full_cpu)):
        init = M.init_params(cfg, normals=np.zeros((cfg.J, cfg.d), np.float32), device=where)
        evs[where] = evaluate_coreset(cfg, scaler, Y, ff, k, "l2-hull", build_plans=plans,
                                      init=init, steps=TABLE1_STEPS, device=where)
    g = {key: abs(getattr(evs[dev], key) - getattr(evs["cpu"], key))
         for key in TABLE1_GATE}
    g["param_l2"] /= abs(evs["cpu"].param_l2)
    g["lambda_err"] /= max(abs(evs["cpu"].lambda_err), 1e-2)
    out["card_vs_cpu_l2_hull_k100"] = {"card": dataclasses.asdict(evs[dev]),
                                       "cpu": dataclasses.asdict(evs["cpu"]), "diff": g}
    log(f"table 1 l2-hull k=100 card vs CPU (param_l2, lambda_err relative; LR absolute): "
        f"{json.dumps(g)}")
    for key, lim in TABLE1_GATE.items():
        if not g[key] <= lim:
            errs.append(f"table 1 l2-hull k=100 card vs CPU {key}: {g[key]} > {lim}")
    return out


def _core_leverage(dev, census, errs, X) -> dict:
    """The five leverage variants on the card at X's width, each against
    float64 of the same X within LEVERAGE_RTOL, then each variant's control
    (LEVERAGE_CONTROL), which must lie beyond it; the census counts the
    variants' runs, not the float64 or the controls."""
    import torch

    from repro_torch.core import leverage as L
    from repro_torch.core.scoring import sketch_plan

    reset_counts()
    plan = sketch_plan(X.shape[0], SKETCH, generator=torch.Generator().manual_seed(7), device=dev)
    calls = {
        # the full basis is rank deficient (each block a partition of unity),
        # where QR leverage is ill-defined: QR scores the basis less one column
        "qr": lambda Z: L.leverage_scores_qr(Z[:, 1:], device=dev),
        "gram": lambda Z: L.leverage_scores_gram(Z, device=dev),
        "ridge": lambda Z: L.ridge_leverage_scores(Z, device=dev),
        "root": lambda Z: L.root_leverage_scores(Z, device=dev),
        "sketched": lambda Z: L.sketched_leverage(Z, SKETCH, plan=plan, device=dev),
    }
    out, exact = {}, {}
    for name, fn in calls.items():
        t0 = time.perf_counter()
        got = fn(X)
        _sync()
        secs = time.perf_counter() - t0
        exact[name] = fn(X.double())
        out[name] = {"max_rel_err": rel_err(got.double().cpu(), exact[name].cpu()), "s": secs,
                     "sum": float(got.double().sum()), "finite": bool(torch.isfinite(got).all())}
    census["standalone leverage"] = read_counts()
    gram_kernel = L.gram_matrix
    for name, fn in calls.items():
        control = LEVERAGE_CONTROL[name]
        L.gram_matrix = _tf32_gram if control == "TF32 Gram" else gram_kernel
        try:
            got = fn(X.bfloat16().float() if control == "bf16 X" else X)
        finally:
            L.gram_matrix = gram_kernel
        r = out[name]
        r["control"] = control
        r["control_rel_err"] = rel_err(got.double().cpu(), exact[name].cpu())
        lim = LEVERAGE_RTOL[name]
        log(f"standalone {name} leverage ({X.shape[0]:,} × {X.shape[1]}): max rel err "
            f"{r['max_rel_err']:.3e} against float64 (limit {lim:g}, "
            f"{lim / r['max_rel_err']:.1f}× inside), Σu {r['sum']:.4f}, {r['s']:.4f}s; control ({control}) "
            f"{r['control_rel_err']:.3e}, {r['control_rel_err'] / lim:.2f}× the limit")
        if not (r["max_rel_err"] <= lim and r["finite"]):
            errs.append(f"standalone {name} leverage lies {r['max_rel_err']} from float64")
        if not r["control_rel_err"] > lim:
            errs.append(f"LEVERAGE_RTOL[{name!r}] does not separate the {control} control: {r}")
    return out


def _core_standalone(dev, census, errs, params) -> dict:
    """The standalone API at the path's width: X (250,001, 14) and P
    (500,002, 7) of normal_mixture seed 0 featurized on the card."""
    import numpy as np
    import torch

    from repro_torch.core import hull as H
    from repro_torch.core import mctm as M
    from repro_torch.core.bernstein import DataScaler
    from repro_torch.core.scoring import ScoringEngine, _mctm_featurize
    from repro_torch.data.dgp import generate
    from repro_torch.kernels.extremes.ref import directional_extremes_ref

    cfg = M.MCTMConfig(J=2, degree=6)
    Yn = generate("normal_mixture", MAIN_N, seed=0).astype(np.float32)
    scaler = DataScaler.fit(Yn)
    X, P = _mctm_featurize(cfg, scaler)(torch.as_tensor(Yn, device=dev))
    out = {"leverage": _core_leverage(dev, census, errs, X)}

    normals = H.hull_normals(1600, cfg.d, torch.Generator().manual_seed(8))
    reset_counts()
    t0 = time.perf_counter()
    ids = H.epsilon_kernel_indices(P, 400, normals=normals, device=dev)
    eps_s = time.perf_counter() - t0
    census["epsilon_kernel_indices"] = read_counts()
    reset_counts()
    q_in, q_out = P.mean(0), P.max(0).values * 1.5
    greedy = [H.greedy_hull_projection(P, q, 1e-2, 64, device=dev) for q in (q_in, q_out)]
    dist_in = H.hull_distance(P, q_in, eps=1e-2, max_iter=64, device=dev)
    census["greedy_hull_projection (m = 1)"] = read_counts()
    real = H.directional_extremes
    H.directional_extremes = directional_extremes_ref
    try:
        plain_ids = H.epsilon_kernel_indices(P, 400, normals=normals, device=dev)
        plain = [H.greedy_hull_projection(P, q, 1e-2, 64, device=dev) for q in (q_in, q_out)]
    finally:
        H.directional_extremes = real
    out["epsilon_kernel"] = {"ids": int(ids.size), "same_as_plain": bool(
        np.array_equal(ids, plain_ids)), "s": eps_s}
    log(f"standalone epsilon_kernel_indices k=400 (1,614 directions over 500,002 rows): "
        f"{json.dumps(out['epsilon_kernel'])}")
    if not out["epsilon_kernel"]["same_as_plain"] or ids.size != 400:
        errs.append("epsilon_kernel_indices on the kernel differs from its plain version")
    out["greedy"] = {}
    for tag, (t, s, d), (tp, sp, dp) in zip(("mean", "outside"), greedy, plain):
        r = {"same_support": bool(torch.equal(s, sp)),
             "t_max_abs_err": float((t - tp).abs().max()),
             "dist": float(d[-1]), "support_points": int((s >= 0).sum())}
        out["greedy"][tag] = r
        log(f"standalone greedy_hull_projection from the {tag} (max_iter 64): {json.dumps(r)}")
        if not r["same_support"] or r["t_max_abs_err"] > 1e-6:
            errs.append(f"greedy_hull_projection from the {tag} differs from its plain version")
    out["greedy"]["hull_distance_mean"] = dist_in
    log(f"standalone hull_distance(mean) {dist_in:.3e} (eps 1e-2, max_iter 64)")
    if not dist_in < 1e-2:
        errs.append(f"hull_distance of the cloud's mean is {dist_in}")

    normals_s = torch.randn((MAIN_N, cfg.J), generator=torch.Generator().manual_seed(9))
    t0 = time.perf_counter()
    got = M.sample(cfg, params, scaler, MAIN_N, normals=normals_s, device=dev)
    _sync()
    sample_s = time.perf_counter() - t0
    p_cpu = M.params_from_numpy(*M.params_to_numpy(params), device="cpu")
    want = M.sample(cfg, p_cpu, scaler, MAIN_N, normals=normals_s, device="cpu")
    span = torch.as_tensor(scaler.high - scaler.low, dtype=torch.float32)
    g = got.cpu()
    low = torch.as_tensor(scaler.low, dtype=torch.float32)
    high = torch.as_tensor(scaler.high, dtype=torch.float32)
    out["sample"] = {"max_err_of_span": float(((g - want) / span).abs().max()), "s": sample_s,
                     "finite": bool(torch.isfinite(g).all()),
                     "in_range": bool(((g >= low) & (g <= high)).all())}
    log(f"standalone sample n={MAIN_N:,}: {json.dumps(out['sample'])}")
    if (out["sample"]["max_err_of_span"] > SAMPLE_SPAN_ATOL or not out["sample"]["finite"]
            or not out["sample"]["in_range"]):
        errs.append(f"sample on the card: {out['sample']}")

    Xc, Pc = X.cpu(), P.cpu()
    Yidx = np.stack([np.arange(MAIN_N), np.zeros(MAIN_N)], axis=1).astype(np.float32)
    res = {}
    for where, dtype in ((dev, "float64"), ("cpu", "float64"), (dev, "float32")):
        t0 = time.perf_counter()
        res[(str(where), dtype)] = ScoringEngine(
            featurize=lookup_featurizer(Xc, Pc, where), rows_per_point=2, chunk_size=CHUNK,
            gram_dtype=dtype, device=where).score(Yidx, method="l2-only").scores
        res[(str(where), dtype, "s")] = time.perf_counter() - t0
    a, b, c = res[(str(dev), "float64")], res[("cpu", "float64")], res[(str(dev), "float32")]
    out["float64_two_pass"] = {"card_vs_cpu": rel_err(a, b), "float32_vs_float64": rel_err(c, a),
                               "card_s": res[(str(dev), "float64", "s")],
                               "card_float32_s": res[(str(dev), "float32", "s")]}
    log(f"standalone TwoPassExact gram_dtype=float64 n={MAIN_N:,} (identical features): "
        f"{json.dumps(out['float64_two_pass'])}")
    if out["float64_two_pass"]["card_vs_cpu"] > F64_SCORE_RTOL or not np.all(np.isfinite(a)):
        errs.append(f"float64 two-pass card vs CPU: {out['float64_two_pass']}")
    return out


# ---------------------------------------------------------------- phase 4


SERVE_MODELS = ("tinyllama_1b", "mamba2_370m")
SERVE_SLOTS = 4
SERVE_MAX_LEN = 2048
SERVE_PROMPTS = (256, 512, 768, 1024) * 2   # multiples of mamba2's chunk 256
SERVE_NEW = 32
# the engine's logits (4-slot batched decode) against a single-request run of
# the same model fed the same tokens: bf16 rounds in other places when the
# batch differs (other GEMM tilings), through 22 or 48 layers, so agreement
# is held to 5e-2 of max|logits| (≈ 6 bf16 ulps at the largest logit)
TEACHER_FORCED_REL = 5e-2


def fa_bound_use(got, q, k, v, causal) -> tuple[float, int]:
    """The largest |got − o| / bound over the elements (≤ 1 passes), with o
    and the bound from ``flash_attention.ref.bf16_error_bound``, and the
    query position where it is reached."""
    from repro_torch.kernels.flash_attention.ref import bf16_error_bound

    o, bound = bf16_error_bound(q, k, v, causal=causal)
    use = (got.float() - o).abs() / bound
    at = int(use.argmax())
    return float(use.flatten()[at]), at // (q.shape[2] * q.shape[3]) % q.shape[1]


def phase_lm_kernels(dev):
    """flash_attention and ssd against their plain versions at the serve
    path's prefill shapes (and ragged, f32 and state-in/out variants)."""
    import numpy as np
    import torch

    from repro_torch.kernels.flash_attention.ops import flash_attention, kernel_path
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.ssd.ops import kernel_path as ssd_path
    from repro_torch.kernels.ssd.ops import ssd_chunked
    from repro_torch.kernels.ssd.ref import ssd_chunked_ref

    gen = torch.Generator().manual_seed(11)
    rows, errs = [], []

    # ---- flash_attention: tinyllama prefill, (1, 1024, 32, 64) q, 4 KV heads
    B, S, H, KV, d = 1, 1024, 32, 4, 64

    def qkv(S_, dtype):
        t = torch.randn(B, S_, H + 2 * KV, d, generator=gen).to(dev, dtype)
        return (t[:, :, :H].contiguous(), t[:, :, H:H + KV].contiguous(),
                t[:, :, H + KV:].contiguous())

    fa_err = 0.0
    for S_, dtype, causal, tol in ((S, torch.bfloat16, True, 3e-2), (777, torch.bfloat16, True, 3e-2),
                                   (S, torch.bfloat16, False, 3e-2), (S, torch.float32, True, 2e-5),
                                   (777, torch.float32, False, 2e-5)):
        q, k, v = qkv(S_, dtype)
        got = flash_attention(q, k, v, causal=causal)
        ref = flash_attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        e = max_err(got, ref)
        fa_err = max(fa_err, e)
        tag = f"S={S_} {str(dtype).split('.')[-1]} causal={causal} path={kernel_path(q)}"
        ok = e <= tol and bool(torch.isfinite(got).all())
        msg = f"  flash_attention {tag}: max abs err {e:.3e} (tol {tol:g})"
        if dtype == torch.bfloat16:
            use, row = fa_bound_use(got, q, k, v, causal)
            ok = ok and use <= 1.0
            msg += f", per-element bound use {use:.3f} (≤ 1) at query {row}"
        log(msg)
        if not ok:
            errs.append(f"flash_attention {tag} disagrees: {e}")
    q, k, v = qkv(S, torch.bfloat16)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    pairs = H * B * S * (S + 1) / 2                   # (query, key) pairs the causal mask keeps
    if kernel_path(q) != "wgmma":
        errs.append(f"flash_attention takes the {kernel_path(q)} body at the serve shape")
    rows.append(kernel_row(
        "flash_attention", "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/kernel.py:62", fa_err,
        lambda: flash_attention(q, k, v), lambda: flash_attention_ref(q, k, v),
        lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True),
        nbytes=2 * (2 * q.numel() + k.numel() + v.numel()), flops=4 * d * pairs,
        peak=H100_BF16_FLOPS))

    # ---- flash_attention at d = 128, olmo-1b's heads (16 × 128, no GQA):
    # checked and timed against SDPA in turns; not on this slice's path
    q8, k8, v8 = (torch.randn(B, S, 16, 128, generator=gen).to(dev, torch.bfloat16)
                  for _ in range(3))
    got = flash_attention(q8, k8, v8)
    use, at = fa_bound_use(got, q8, k8, v8, True)
    if use > 1.0 or kernel_path(q8) != "wgmma":
        errs.append(f"flash_attention d=128 uses {use} of its bound ({kernel_path(q8)} body)")
    t8 = in_turns(lambda: flash_attention(q8, k8, v8),
                  lambda: torch.nn.functional.scaled_dot_product_attention(
                      *(t.transpose(1, 2) for t in (q8, k8, v8)), is_causal=True))
    log(f"  flash_attention d=128 (1, 1024, 16, 128) causal: bound use {use:.3f} at query {at}; "
        f"device {t8['device_ms']:.5f} ms vs SDPA {t8['library_device_ms']:.5f} ms (ratio "
        f"{t8['device_ratio']:.3f}, in turns {[round(x, 5) for x in t8['turns_device_ms']]})")

    # ---- ssd: mamba2 prefill, (1, 1024, 32, 64) x, N = 128, chunk 256
    T, H, P, N, Q = 1024, 32, 64, 128, 256

    def ssd_inputs(T_, dtype):
        xbc = torch.randn(B, T_, H * P + 2 * N, generator=gen).to(dev, dtype)
        x = xbc[..., :H * P].reshape(B, T_, H, P)
        Bm = xbc[..., H * P:H * P + N].reshape(B, T_, 1, N)
        Cm = xbc[..., H * P + N:].reshape(B, T_, 1, N)
        dt = (torch.rand(B, T_, H, generator=gen) * 0.1 + 0.005).to(dev)
        A = -torch.linspace(1.0, 16.0, H).to(dev)  # -exp(A_log) of the model's init
        s0 = torch.randn(B, H, P, N, generator=gen).to(dev)
        return x, dt, A, Bm, Cm, s0

    ssd_err = 0.0
    for T_, dtype in ((T, torch.bfloat16), (1000, torch.bfloat16), (T, torch.float32),
                      (1000, torch.float32), (256, torch.bfloat16), (777, torch.bfloat16)):
        args = ssd_inputs(T_, dtype)
        y, st = ssd_chunked(*args, chunk=Q)
        yr, sr = ssd_chunked_ref(*args, chunk=Q)
        torch.cuda.synchronize()
        ytol = (1e-2 if dtype == torch.bfloat16 else 1e-4) * float(yr.float().abs().max())
        stol = 1e-4 * float(sr.abs().max())
        ey, es = max_err(y, yr), max_err(st, sr)
        ssd_err = max(ssd_err, ey, es)
        path = ssd_path(args[0], N)
        tag = f"T={T_} {str(dtype).split('.')[-1]} state0 nonzero path={path}"
        log(f"  ssd {tag}: y max abs err {ey:.3e} (tol {ytol:.3e}, {ey / ytol:.4f} of it), "
            f"state {es:.3e} (tol {stol:.3e}, {es / stol:.4f} of it)")
        if not (ey <= ytol and es <= stol and torch.isfinite(y).all()):
            errs.append(f"ssd {tag} disagrees: y {ey}, state {es}")
        if path != ("mma" if dtype == torch.bfloat16 else "simt"):
            errs.append(f"ssd {tag} took the {path} body")
        if dtype == torch.bfloat16 and T_ == T:
            y2, st2 = ssd_chunked(*args, chunk=Q)
            if not (torch.equal(y, y2) and torch.equal(st, st2)):
                errs.append(f"ssd {tag} is not bit-identical across calls")

    def ssd_work(T_):
        """Bytes, f32 FLOP (the scan's arithmetic) and bf16 tensor-core FLOP
        (the mma body's: three passes of the intra, inter and state products,
        C Bᵀ once per head) of one call at T_ (a multiple of Q)."""
        tri, n_ch = Q * (Q + 1) / 2, B * (T_ // Q)
        nbytes = 2 * 2 * B * T_ * H * P + 4 * B * T_ * H + 4 * H + 2 * 2 * B * T_ * N \
            + 2 * 4 * B * H * P * N
        f32 = 2 * n_ch * (tri * N + H * (tri * P + 2 * Q * N * P))
        bf16x3 = 2 * n_ch * H * (tri * N + 3 * (tri * P + 2 * Q * N * P))
        return nbytes, f32, bf16x3

    for T_ in (256, T):
        a_ = ssd_inputs(T_, torch.bfloat16)
        nbytes, f32, bf16x3 = ssd_work(T_)
        b32, _ = bound_ms(nbytes, f32)
        b16, by = bound_ms(nbytes, bf16x3, H100_BF16_FLOPS)
        dms = device_ms(lambda: ssd_chunked(*a_, chunk=Q))
        log(f"  ssd T={T_} bf16 (mma body): device {dms:.5f} ms, events "
            f"{cuda_ms(lambda: ssd_chunked(*a_, chunk=Q)):.5f} ms; f32 CUDA-core bound "
            f"{b32:.5f} ms ({f32 / 1e9:.3f} GFLOP at 67 TFLOP/s); bf16x3 tensor-core bound "
            f"{b16:.5f} ms ({by}; {bf16x3 / 1e9:.3f} GFLOP at 989 TFLOP/s, {nbytes / 1e6:.3f} MB); "
            f"{b16 / dms:.3f} of it")
    args = ssd_inputs(T, torch.bfloat16)
    nbytes, f32, bf16x3 = ssd_work(T)
    ssd_row = kernel_row(
        "ssd", "src/repro_torch/csrc/ssd.cu", "src/repro/kernels/ssd/kernel.py:63", ssd_err,
        lambda: ssd_chunked(*args, chunk=Q), lambda: ssd_chunked_ref(*args, chunk=Q), None,
        nbytes=nbytes, flops=bf16x3, peak=H100_BF16_FLOPS)
    ssd_row["bound_f32_ms"] = bound_ms(nbytes, f32)[0]
    rows.append(ssd_row)
    if errs:
        fail("; ".join(errs))
    return rows


def phase_lm_small_agreement(dev):
    """The reduced LMs served on the card and on the CPU from the same f32
    weights: the same greedy tokens, logits within 1e-4."""
    import numpy as np
    import torch

    from repro_torch.configs import get_reduced_config
    from repro_torch.models import build_model
    from repro_torch.serve import GenerationConfig, Request, ServeEngine

    for name in SERVE_MODELS:
        cfg = get_reduced_config(name).replace(dtype="float32")
        runs = {}
        for where in ("cpu", str(dev)):
            model = build_model(cfg, device="cpu", seed=5).to(where)
            eng = ServeEngine(model, n_slots=2, max_len=80, device=where, keep_logits=True)
            eng.cache["pos"] = torch.zeros(2, dtype=torch.int32, device=where)
            rng = np.random.default_rng(6)
            # the last request decodes long enough for the other, finished
            # slot's pos to run past the cache's 80 positions
            for i, (n, new) in enumerate(((16, 8), (48, 8), (7, 8), (32, 8), (4, 60))):
                eng.submit(Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                                   gen=GenerationConfig(max_new_tokens=new)))
            runs[where] = sorted(eng.run_until_drained(), key=lambda r: r.uid)
            if int(eng.cache["pos"].max()) <= 80:
                fail(f"reduced {name}: no finished slot ran past the cache end")
        e = max(float(np.abs(np.stack(a.logits) - np.stack(b.logits)).max())
                for a, b in zip(runs[str(dev)], runs["cpu"]))
        same = len(runs["cpu"]) == 5 and all(
            a.output == b.output for a, b in zip(runs[str(dev)], runs["cpu"]))
        log(f"small LM {name}: same greedy tokens {same}, max logit err {e:.3e}")
        if not same or e > 1e-4:
            fail(f"reduced {name} on the card disagrees with the CPU: tokens {same}, err {e}")


PROFILE_TICKS = 8


def profile_window(fn, match: str | None = None) -> dict:
    """Host wall time of ``fn`` (ending in a device sync), the device's busy
    time (the sum of its kernels' durations: one stream, so they do not
    overlap), its idle share 1 − busy / wall, its launches and the kernels
    with the most device time, from ``torch.profiler``; with ``match``, also
    the device time and share of the kernels whose names contain it."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = collections.defaultdict(float)
    launches = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] += e.time_range.elapsed_us()
            launches += 1
    busy_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out = {
        "wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / wall_us, "device_launches": launches,
        "top_kernels_ms": {name[:90]: us / 1e3 for name, us in top},
    }
    if match is not None:
        m_us = sum(us for name, us in by_name.items() if match in name)
        out[f"{match}_device_ms"] = m_us / 1e3
        out[f"{match}_share_of_device"] = m_us / busy_us if busy_us else 0.0
    return out


def profile_serve(model, engine, prompts, kernel: str) -> dict:
    """The serve path's two windows: one prefill of a 1,024-token prompt into
    a 1-slot cache (as the engine admits a request), with ``kernel``'s share
    of its device time, and PROFILE_TICKS batched decode ticks with all
    slots live."""
    from repro_torch.serve import GenerationConfig, Request

    prompt = prompts[SERVE_PROMPTS.index(1024)]

    def prefill():
        cache = model.init_cache(1, SERVE_MAX_LEN)
        logits, _ = model.prefill({"tokens": prompt[None, :]}, cache)
        logits.float().cpu()

    out = {"prefill_1024": profile_window(prefill, match=kernel)}
    eng = engine()
    for i, p in enumerate(prompts[:SERVE_SLOTS]):
        eng.submit(Request(uid=i, prompt=p, gen=GenerationConfig(max_new_tokens=SERVE_NEW)))
    eng.step()  # admits every slot and runs the first tick
    eng.step()

    def ticks():
        for _ in range(PROFILE_TICKS):
            eng.step()

    out[f"decode_{PROFILE_TICKS}_ticks"] = profile_window(ticks)
    return out


def phase_serve(dev):
    """Each full-width model serving 8 requests through ServeEngine; returns
    the launches of flash_attention and ssd over their serve runs."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssd import ops as ssd
    from repro_torch.models import build_model
    from repro_torch.serve import GenerationConfig, Request, ServeEngine

    launches, records = {}, {}
    for name in SERVE_MODELS:
        cfg = get_config(name)
        kernel = fa if cfg.family == "dense" else ssd
        kname = "flash_attention" if cfg.family == "dense" else "ssd"
        t0 = time.perf_counter()
        model = build_model(cfg, device=dev, seed=0)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in model.parameters())
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in SERVE_PROMPTS]

        def engine():
            eng = ServeEngine(model, n_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN, device=dev,
                              keep_logits=True)
            eng.cache["pos"] = torch.zeros(SERVE_SLOTS, dtype=torch.int32, device=dev)
            return eng

        warm = engine()  # first calls: cuBLAS handles, allocator pools
        warm.submit(Request(uid=-1, prompt=prompts[0], gen=GenerationConfig(max_new_tokens=2)))
        warm.run_until_drained()
        del warm
        torch.cuda.reset_peak_memory_stats()
        eng = engine()
        for mod in (fa, ssd):
            mod.LAUNCHES = 0
        fa.PATH_LAUNCHES.update(dict.fromkeys(fa.PATH_LAUNCHES, 0))
        ssd.PATH_LAUNCHES.update(dict.fromkeys(ssd.PATH_LAUNCHES, 0))
        t0 = time.perf_counter()
        for i, p in enumerate(prompts):
            eng.submit(Request(uid=i, prompt=p, gen=GenerationConfig(max_new_tokens=SERVE_NEW)))
        done = eng.run_until_drained()
        torch.cuda.synchronize()
        drain_s = time.perf_counter() - t0
        count = kernel.LAUNCHES
        launches[kname] = count
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        done.sort(key=lambda r: r.uid)
        if len(done) != len(prompts) or any(len(r.output) != SERVE_NEW for r in done):
            fail(f"{name}: {len(done)} of {len(prompts)} requests finished, outputs "
                 f"{[len(r.output) for r in done]}")
        if not all(np.isfinite(row).all() for r in done for row in r.logits):
            fail(f"{name}: a logit is not finite")
        if count != cfg.n_layers * len(prompts):
            fail(f"{name}: {kname} launched {count} times, expected "
                 f"{cfg.n_layers} layers × {len(prompts)} prefills")
        bodies = dict(fa.PATH_LAUNCHES if cfg.family == "dense" else ssd.PATH_LAUNCHES)
        body = "wgmma" if cfg.family == "dense" else "mma"
        if bodies[body] != count:
            fail(f"{name}: the {body} body took {bodies[body]} of {count} launches {bodies}")
        # teacher-forced: a single-request run of the same model fed the engine's tokens
        tf_err, tf_scale, agree = 0.0, 0.0, 0
        for r in done:
            cache = model.init_cache(1, SERVE_MAX_LEN)
            logits, cache = model.prefill({"tokens": r.prompt[None, :]}, cache)
            rows_ = [logits[0, -1].float().cpu().numpy()]
            for tok in r.output[:-1]:
                logits, cache = model.decode_step(np.asarray([[tok]]), cache)
                rows_.append(logits[0, -1].float().cpu().numpy())
            a, b = np.stack(r.logits), np.stack(rows_)
            tf_err = max(tf_err, float(np.abs(a - b).max()))
            tf_scale = max(tf_scale, float(np.abs(b).max()))
            agree += int((a.argmax(-1) == b.argmax(-1)).sum())
        pre = np.asarray(eng.prefill_seconds) * 1e3
        tick = np.asarray(eng.tick_seconds) * 1e3
        rec = {
            "model": cfg.name, "params": n_params, "load_s": load_s, "requests": len(done),
            "prompt_tokens": int(sum(SERVE_PROMPTS)), "new_tokens": SERVE_NEW * len(done),
            "prefill_ms": dict(zip(map(str, SERVE_PROMPTS[:4]),
                                   [float(np.mean(pre[i::4])) for i in range(4)])),
            "prefill_ms_mean": float(pre.mean()), "ticks": eng.ticks,
            "decode_ms_per_tick_median": float(np.median(tick)),
            "decode_ms_per_tick_mean": float(tick.mean()), "drain_s": drain_s,
            "generated_tokens_per_s": SERVE_NEW * len(done) / drain_s,
            "peak_memory_gb": peak_gb, f"{kname}_launches": count,
            "teacher_forced_max_abs_err": tf_err, "teacher_forced_max_abs_logit": tf_scale,
            "teacher_forced_argmax_agree": f"{agree}/{SERVE_NEW * len(done)}",
        }
        rec[f"{kname}_launches_by_body"] = bodies
        records[name] = rec
        log(f"serve {name}: " + json.dumps(rec))
        if tf_err > TEACHER_FORCED_REL * tf_scale:
            fail(f"{name}: engine logits differ from the single-request run by {tf_err} "
                 f"(> {TEACHER_FORCED_REL} × {tf_scale})")
        rec["profile"] = profile_serve(model, engine, prompts,
                                       "flash" if cfg.family == "dense" else "ssd")
        log(f"serve profile {name}: " + json.dumps(rec["profile"]))
        del model, eng
        torch.cuda.empty_cache()
    return launches, records


# ---------------------------------------------------------------- phase 7

FT_EVERY = 4                      # sweep_ckpt_every_chunks: 16 chunks, 4 saves a sweep
FT_SCORING_CRASHES = (6, 16 + 11)  # sweep 1's chunk 6, sweep 2's chunk 11 (two-pass)
FT_K = 2000
FT_STEPS = 250
DRILL_ARGV = ["--inject-failures", "--n", "50001", "--ks", "500", "--steps", "250"]


def _ckpt_bytes(root: str, n_chunks: int, every: int) -> int:
    """Bytes one uninterrupted checkpointed sweep call wrote: each sweep's
    payload (fixed shape: its latest step's files) times its saves, plus
    the generator's entry state."""
    total = 0
    for sub in ("entry", "sweep1", "sweep2"):
        d = os.path.join(root, sub)
        if not os.path.isdir(d):
            continue
        steps = sorted(x for x in os.listdir(d) if re.fullmatch(r"step_\d+", x))
        if not steps:
            continue
        last = os.path.join(d, steps[-1])
        size = sum(os.path.getsize(os.path.join(last, f)) for f in os.listdir(last))
        total += size * (1 if sub == "entry" else -(-n_chunks // every))
    return total


def phase_fault_tolerance(dev, scratch: str):
    """Phase 7 at the path's full width (J = 2, degree 6, n = 250,001,
    chunk 16,384): resumable builds of both strategies crashed mid-sweep and
    driven to completion through ``RunSupervisor``, held to the uninterrupted
    build's bits; adam and lbfgs coreset fits recovered bit-identically
    (after two straight runs agree), a NaN-weighted fit aborting with the
    diagnostic; the driver's ``--inject-failures`` drill. Returns (census,
    records)."""
    import numpy as np
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import mctm as M
    from repro_torch.core.bernstein import DataScaler
    from repro_torch.core.coreset import build_coreset
    from repro_torch.core.mctm_fit import fit_mctm_streaming
    from repro_torch.core.scoring import ScoringEngine
    from repro_torch.data.dgp import generate
    from repro_torch.ft import FailureSimulator, RunSupervisor, get_ft_config
    from repro_torch.ft.config import ft_overrides
    from repro_torch.launch import train_mctm

    errs: list[str] = []
    census: dict = {}
    rec: dict = {}
    ft = get_ft_config()
    cfg = M.MCTMConfig(J=2, degree=6)
    Yn = generate("normal_mixture", MAIN_N, seed=0).astype(np.float32)
    scaler = DataScaler.fit(Yn)
    eng = ScoringEngine(cfg, scaler, chunk_size=CHUNK, device=dev)
    n_chunks = -(-MAIN_N // CHUNK)
    k2 = FT_K - int(0.8 * FT_K)

    # ---- resumable builds
    for strategy, kw in (("two-pass", {}), ("one-pass", {"sketch_size": SKETCH})):
        args = dict(method="l2-hull", hull_k=k2, strategy=strategy, **kw)

        def score(ckpt=None, resume=False, gen=None):
            gen = torch.Generator().manual_seed(21) if gen is None else gen
            return eng.score(Yn, generator=gen, sweep_ckpt=ckpt, resume=resume, **args)

        score()  # warm
        _sync()
        t0 = time.perf_counter()
        plain = score()
        _sync()
        plain_s = time.perf_counter() - t0
        d_clean = os.path.join(scratch, f"build_{strategy}_clean")
        with ft_overrides(sweep_ckpt_every_chunks=FT_EVERY):
            t0 = time.perf_counter()
            clean = score(d_clean)
            _sync()
            ckpt_s = time.perf_counter() - t0
            nbytes = _ckpt_bytes(d_clean, n_chunks, FT_EVERY)
            d = os.path.join(scratch, f"build_{strategy}")
            sim = FailureSimulator()
            for c in FT_SCORING_CRASHES:
                sim.inject("scoring", c)
            ft.simulator = sim
            sup = RunSupervisor(label=f"phase7 {strategy} build")
            gen = torch.Generator().manual_seed(21)  # one generator across the attempts
            reset_counts()
            try:
                t0 = time.perf_counter()
                got = sup.run(lambda ctx: score(d, ctx.resume, gen))
                _sync()
                resumed_s = time.perf_counter() - t0
            finally:
                ft.simulator = None
            census[f"resumable {strategy} build"] = read_counts()
        same = {
            name: bool(torch.equal(torch.as_tensor(getattr(plain, name)),
                                   torch.as_tensor(getattr(got, name))))
            for name in ("scores", "gram", "hull_rows")}
        same_clean = all(np.array_equal(getattr(plain, nm), getattr(clean, nm))
                         for nm in ("scores", "gram", "hull_rows"))
        r = {"plain_s": plain_s, "checkpointed_s": ckpt_s, "crashed_and_resumed_s": resumed_s,
             "checkpoint_bytes": nbytes, "injected": [e["step"] for e in sim.log],
             "attempts": len(sup.events) + 1, "same_bits_as_uninterrupted": same,
             "checkpointed_same_bits": same_clean}
        rec[f"build_{strategy}"] = r
        log(f"phase 7 resumable {strategy} build (n={MAIN_N:,}, {n_chunks} chunks, save every "
            f"{FT_EVERY}): {json.dumps(r)}")
        want = [c for c in FT_SCORING_CRASHES if c <= (2 if strategy == "two-pass" else 1) * n_chunks]
        if r["injected"] != want or not all(same.values()) or not same_clean:
            errs.append(f"resumable {strategy} build: {r}")

    # ---- fit recovery on the k = 2,000 coreset
    cs = build_coreset(cfg, scaler, Yn, FT_K, "l2-hull", generator=torch.Generator().manual_seed(22),
                       chunk_size=CHUNK, device=dev)
    Ycs, wcs = Yn[cs.indices], np.asarray(cs.weights, np.float32)

    def fit(method, tag, inject=(), every=50, **kw):
        mgr = CheckpointManager(os.path.join(scratch, f"fit_{method}_{tag}"), keep=2)
        sim = FailureSimulator()
        for phase, step in inject:
            sim.inject(phase, step)
        ft.simulator = sim if inject else None
        try:
            t0 = time.perf_counter()
            out = fit_mctm_streaming(cfg, scaler, Ycs, wcs, generator=torch.Generator().manual_seed(23),
                                     steps=FT_STEPS, lr=0.05, method=method, chunk_size=CHUNK,
                                     checkpoint=mgr, ckpt_every=every, device=dev, **kw)
            _sync()
            return out, time.perf_counter() - t0, [(e["phase"], e["step"]) for e in sim.log]
        finally:
            ft.simulator = None

    def same_params(a, b):
        return all(torch.equal(getattr(a.params, f), getattr(b.params, f))
                   for f in a.params._fields)

    for method, every, inject in (("adam", 50, (("fit", 120), ("checkpoint", 200))),
                                  ("lbfgs", 10, (("fit", 30),))):
        reset_counts()
        s1, t1, _ = fit(method, "straight1", every=every)
        s2, t2, _ = fit(method, "straight2", every=every)
        rec_, tr, log_ = fit(method, "injected", inject, every=every)
        census[f"fit recovery ({method})"] = read_counts()
        r = {"straight_s": [t1, t2], "recovered_s": tr, "injected": log_,
             "straight_runs_agree": same_params(s1, s2),
             "recovered_same_bits": same_params(s1, rec_),
             "final_loss": [float(s1.losses[-1]), float(rec_.losses[-1])]}
        if method == "adam":  # the finiteness read: one host sync a step, in turns
            turns = []
            for check in (True, False, False, True):
                with ft_overrides(nonfinite_rollback=check):
                    turns.append(fit(method, f"check_{check}", every=0)[1])
            r["checked_s"], r["unchecked_s"] = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
            r["check_turns_s"] = turns
        rec[f"fit_{method}"] = r
        log(f"phase 7 {method} fit recovery (k={FT_K}, {FT_STEPS} steps, ckpt every {every}): "
            f"{json.dumps(r)}")
        if not r["straight_runs_agree"]:
            errs.append(f"two straight {method} fits on the card differ: an op on the fit path "
                        "is not deterministic")
        if not r["recovered_same_bits"] or r["injected"] != list(inject):
            errs.append(f"{method} fit recovery: {r}")
    # the finiteness read on the full data's adam fit (16 microbatches a
    # step, one read a step), 50 steps, in turns
    turns = []
    for check in (True, False, False, True):
        with ft_overrides(nonfinite_rollback=check):
            _sync()
            t0 = time.perf_counter()
            fit_mctm_streaming(cfg, scaler, Yn, generator=torch.Generator().manual_seed(24),
                               steps=50, method="adam", chunk_size=CHUNK, device=dev)
            _sync()
            turns.append(time.perf_counter() - t0)
    rec["full_fit_check_turns_s"] = turns
    log(f"phase 7 adam full fit (n={MAIN_N:,}, 50 steps) with / without the finiteness read, "
        f"in turns (checked, unchecked, unchecked, checked): {[round(t, 4) for t in turns]} s")
    bad = wcs.copy()
    bad[0] = np.nan
    with ft_overrides(backoff_base_s=0.0):
        try:
            fit_mctm_streaming(cfg, scaler, Ycs, bad, generator=torch.Generator().manual_seed(23),
                               steps=FT_STEPS, method="adam", chunk_size=CHUNK, device=dev)
            msg = None
        except RuntimeError as e:
            msg = str(e)
    want = f"retry budget exhausted after {ft.max_retries + 1} attempts"
    rec["nan_fit_abort"] = (msg or "").splitlines()[0] if msg else None
    log(f"phase 7 NaN-weighted fit: {rec['nan_fit_abort']}")
    if msg is None or want not in msg or "non-finite" not in msg:
        errs.append(f"a NaN-weighted fit did not abort with the diagnostic: {msg}")

    # ---- the driver's drill
    reset_counts()
    t0 = time.perf_counter()
    try:
        drill = train_mctm.main(["--device", "cuda", *DRILL_ARGV])
    except SystemExit as e:
        fail(f"phase 7: train_mctm {' '.join(DRILL_ARGV)} exited {e.code}")
    census["driver drill"] = read_counts()
    r = {"s": time.perf_counter() - t0, "injected": drill["ft"]["injected"],
         "supervisor_events": len(drill["ft"]["supervisor_events"]),
         "ratio": drill["per_k"][0]["ratio"], "band": drill["per_k"][0]["band"],
         "within_band": drill["all_within_band"], "full_fit_s": drill["full_fit_s"]}
    rec["driver_drill"] = r
    log(f"phase 7 driver drill (train_mctm {' '.join(DRILL_ARGV)}): {json.dumps(r)}")
    if len(r["injected"]) != 3 or not r["within_band"]:
        errs.append(f"the driver drill: {r}")
    for path, counts in census.items():
        log(f"census {path}: {json.dumps(counts)}")
        if counts.get("bernstein", 0) <= 0:
            errs.append(f"bernstein was not launched on the {path} path")
    if errs:
        fail("phase 7: " + "; ".join(errs))
    return census, rec


# ---------------------------------------------------------------- phase 8

STREAM_WINDOWS, STREAM_ROWS = 16, 65_536
STREAM_K, STREAM_ALPHA = 2000, 0.8
STREAM_KILL = 9                    # maybe_inject("streaming", 9): window 9's push
STREAM_MAINTAINERS = {
    "insertion sketch 784": dict(policy="insertion", sketch_size=SKETCH),
    "insertion exact": dict(policy="insertion", sketch_size=0),
    "sliding W=4": dict(policy="sliding", window=4, sketch_size=SKETCH),
    "decayed gamma=0.9": dict(policy="decayed", decay=0.9, sketch_size=SKETCH),
}
STREAM_NLL_REL = 0.3               # tests/test_streaming.py::test_streaming_nll_close_to_full
DRIFT_CLEAN, DRIFT_SHIFTED = 6, 6


def phase_streaming(dev, scratch: str):
    """Phase 8: Merge & Reduce over a 16 × 65,536-row normal_mixture stream
    (1,048,576 points, J = 2, degree 6, k = 2,000, α = 0.8) through four
    maintainers; policy exactness, result() idempotence, a kill at window 9
    resumed bit-identically, maintain against rebuild, the NLL bound at fixed
    parameters, a refit reported against the full fit, and drift detection
    on clean then shifted windows. Returns (census, records)."""
    import numpy as np
    import torch

    from repro_torch.core import mctm as M
    from repro_torch.core.bernstein import DataScaler
    from repro_torch.core.coreset import build_coreset
    from repro_torch.core.mctm_fit import fit_mctm_streaming, streamed_nll
    from repro_torch.core.streaming import (DriftDetector, StreamingCoresetMaintainer,
                                            drift_window_nll)
    from repro_torch.data.dgp import generate
    from repro_torch.ft import FailureSimulator, InjectedFailure, get_ft_config

    errs: list[str] = []
    census: dict = {}
    rec: dict = {}
    cfg = M.MCTMConfig(J=2, degree=6)
    n = STREAM_WINDOWS * STREAM_ROWS
    Yn = generate("normal_mixture", n, seed=1).astype(np.float32)
    scaler = DataScaler.fit(Yn)
    windows = [Yn[i * STREAM_ROWS:(i + 1) * STREAM_ROWS] for i in range(STREAM_WINDOWS)]

    def make(kw, **extra):
        return StreamingCoresetMaintainer(cfg, scaler, STREAM_K, 31, alpha=STREAM_ALPHA,
                                          device=dev, **kw, **extra)

    results = {}
    for name, kw in STREAM_MAINTAINERS.items():
        m = make(kw)
        reset_counts()
        push_ms = []
        for w in windows:
            t0 = time.perf_counter()
            m.push(w)
            push_ms.append((time.perf_counter() - t0) * 1e3)
        census[f"stream {name}"] = read_counts()
        t0 = time.perf_counter()
        r1 = m.result()
        result_ms = (time.perf_counter() - t0) * 1e3
        r2 = m.result()
        results[name] = r1
        r = {"push_ms_median": float(np.median(push_ms)), "push_ms_max": float(np.max(push_ms)),
             "push_ms_first": push_ms[0], "result_ms": result_ms,
             "live_buckets": len(m.live_buckets()), "live_births": m.live_births(),
             "total_weight": m.total_weight(), "result_size": r1.size,
             "result_idempotent": bool(np.array_equal(r1.Y, r2.Y)
                                       and np.array_equal(r1.weights, r2.weights))}
        if kw["policy"] == "sliding":
            want = 4 * STREAM_ROWS
            r["weight_rel_err"] = abs(r["total_weight"] - want) / want
            if m.live_births() != list(range(STREAM_WINDOWS - 4, STREAM_WINDOWS)) \
                    or r["weight_rel_err"] > 1e-9:
                errs.append(f"sliding W=4: births {m.live_births()}, weight {r['total_weight']}")
        if kw["policy"] == "decayed":
            g = kw["decay"]
            want = STREAM_ROWS * (1 - g ** STREAM_WINDOWS) / (1 - g)
            r["weight_rel_err"] = abs(r["total_weight"] - want) / want
            if r["weight_rel_err"] > 1e-9:
                errs.append(f"decayed: weight {r['total_weight']} against {want}")
        if kw["policy"] == "insertion":
            r["weight_rel_err"] = abs(r["total_weight"] - n) / n
        rec[name] = r
        log(f"phase 8 stream {name}: {json.dumps(r)}")
        if not r["result_idempotent"] or r1.size != STREAM_K:
            errs.append(f"{name}: result() is not idempotent or not k points ({r1.size})")

    # ---- kill at window 9, resume from the checkpoint, re-push
    name = "insertion sketch 784"
    ft = get_ft_config()
    d = os.path.join(scratch, "stream")
    ft.simulator = FailureSimulator().inject("streaming", STREAM_KILL)
    t0 = time.perf_counter()
    try:
        m, done, crashes = make(STREAM_MAINTAINERS[name], ckpt_dir=d), 0, 0
        while done < STREAM_WINDOWS:
            try:
                m.push(windows[done])
                done = m.windows_done
            except InjectedFailure:
                crashes += 1
                m = make(STREAM_MAINTAINERS[name], ckpt_dir=d)
                done = m.resume()
    finally:
        ft.simulator = None
    resumed = m.result()
    r = {"crashes": crashes, "resumed_at": STREAM_KILL - 1, "s": time.perf_counter() - t0,
         "same_bits": bool(np.array_equal(resumed.Y, results[name].Y)
                           and np.array_equal(resumed.weights, results[name].weights))}
    rec["resume"] = r
    log(f"phase 8 {name} killed at window {STREAM_KILL}, resumed: {json.dumps(r)}")
    if crashes != 1 or not r["same_bits"]:
        errs.append(f"the resumed stream differs from the uninterrupted one: {r}")

    # ---- maintain against rebuild
    rb = {}
    for tag, sk in (("one-pass sketch 784", SKETCH), ("two-pass", 0)):
        _sync()
        t0 = time.perf_counter()
        cs = build_coreset(cfg, scaler, Yn, STREAM_K, "l2-hull", generator=torch.Generator().manual_seed(32),
                           sketch_size=sk, chunk_size=STREAM_ROWS, device=dev)
        _sync()
        rb[tag] = time.perf_counter() - t0
    rec["rebuild_s"] = rb
    log(f"phase 8 one batch build_coreset over the {n:,}-row prefix: {json.dumps(rb)} s; a "
        f"maintained window costs {rec[name]['push_ms_median']:.1f} ms (median push)")

    # ---- the NLL of result() at fixed parameters, and a refit
    res = results[name]
    p0 = M.init_params(cfg, generator=torch.Generator().manual_seed(5), device=dev)
    full_pp = streamed_nll(cfg, scaler, p0, Yn, chunk=STREAM_ROWS, device=dev) / n
    wsum = float(res.weights.sum())
    cs_pp = streamed_nll(cfg, scaler, p0, res.Y, res.weights, chunk=STREAM_ROWS, device=dev) / wsum
    nll_rel = abs(cs_pp - full_pp) / abs(full_pp)
    t0 = time.perf_counter()
    full_fit = fit_mctm_streaming(cfg, scaler, Yn, generator=torch.Generator().manual_seed(33),
                                  steps=FT_STEPS, method="adam", chunk_size=STREAM_ROWS, device=dev)
    full_fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cs_fit = fit_mctm_streaming(cfg, scaler, res.Y.astype(np.float32),
                                np.asarray(res.weights, np.float32),
                                generator=torch.Generator().manual_seed(33), steps=FT_STEPS,
                                method="adam", chunk_size=STREAM_ROWS, device=dev)
    cs_fit_s = time.perf_counter() - t0
    at_cs = streamed_nll(cfg, scaler, cs_fit.params, Yn, chunk=STREAM_ROWS, device=dev) / n
    at_full = streamed_nll(cfg, scaler, full_fit.params, Yn, chunk=STREAM_ROWS, device=dev) / n
    rec["nll"] = {"full_pp_at_init": full_pp, "coreset_pp_at_init": cs_pp, "rel": nll_rel,
                  "refit_full_nll_pp": at_cs, "full_fit_nll_pp": at_full,
                  "ratio": at_cs / at_full, "refit_s": cs_fit_s, "full_fit_s": full_fit_s}
    log(f"phase 8 NLL of result() at fixed params and a refit: {json.dumps(rec['nll'])}")
    if not nll_rel <= STREAM_NLL_REL:
        errs.append(f"result()'s weighted NLL lies {nll_rel} from the full data's")

    # ---- drift: params fit on 2 clean windows, 6 clean then 6 shifted windows
    fit2 = fit_mctm_streaming(cfg, scaler, np.concatenate(windows[:2]),
                              generator=torch.Generator().manual_seed(34), steps=FT_STEPS,
                              method="adam", chunk_size=STREAM_ROWS, device=dev)
    det = DriftDetector()
    std = Yn.std(0)
    fired, log_ = [], []
    reset_counts()
    t0 = time.perf_counter()
    for i in range(DRIFT_CLEAN + DRIFT_SHIFTED):
        w = windows[2 + i]
        if i >= DRIFT_CLEAN:
            w = w * 1.6 + 2 * std
        nll_pp = drift_window_nll(cfg, scaler, fit2.params, w, chunk=CHUNK, device=dev)
        fired.append(det.observe(nll_pp))
        log_.append(round(nll_pp, 5))
    drift_s = time.perf_counter() - t0
    census["drift"] = read_counts()
    rec["drift"] = {"nll_pp": log_, "fired": fired, "ewma": det.ewma, "alerts": det.alerts,
                    "s": drift_s}
    log(f"phase 8 drift (6 clean, 6 shifted windows): {json.dumps(rec['drift'])}")
    if any(fired[:DRIFT_CLEAN]) or not any(fired[DRIFT_CLEAN:]):
        errs.append(f"the drift detector fired {fired} (clean first)")
    need = {"stream insertion sketch 784": ("bernstein", "sweep"),
            "stream insertion exact": ("bernstein", "gram", "extremes"),
            "drift": ("bernstein",)}
    for path, counts in census.items():
        log(f"census {path}: {json.dumps(counts)}")
        for kname in need.get(path, ()):
            if counts.get(kname, 0) <= 0:
                errs.append(f"{kname} was not launched on the {path} path")
    if errs:
        fail("phase 8: " + "; ".join(errs))
    return census, rec


# ---------------------------------------------------------------- phase 9

SELECT_K, SELECT_ALPHA = 2048, 0.8
VOCAB = 32_000                       # tinyllama-1.1b's vocabulary
# D: (sequences, tokens a sequence, chunk, one-pass sketch). D = 32 is
# launch/train.py's proxy (a seeded 32,000 × 32 projection, ×0.05, mean-
# pooled), its sketch 4·D²; D = 2,048 pools tinyllama-1.1b's embedding
# table, drawn as phase 4 draws it (the first draw of a generator seeded 0)
SELECT_CASES = {32: (262_144, 64, 65_536, 4_096), 2048: (65_536, 256, 16_384, 16_384)}
# scores against float64 of the same features (two-pass: the exact l2
# scores; one-pass: the engine's float64 sketch, gram_dtype="float64", on the
# same plan); a TF32 Gram (two-pass) and bf16-rounded features (one-pass)
# run through the same check and must fail it. Set from a card run of this
# phase (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md §6): two-pass 3.7e-7 (D 32)
# and 3.0e-7 (D 2,048) against TF32 6.3e-6 and 1.3e-4; one-pass 5.7e-7 and
# 1.07e-6 against bf16 4.3e-3 and 6.0e-4
SELECT_SCORE_RTOL = {"two-pass": 2e-6, "one-pass": 1e-5}
SELECT_HULL_COMMON_FLOOR = 0.9       # hull ids shared with the plain versions' selection
MINI_BATCH, MINI_STEPS = 4096, 250
# phase 3's adam full fit at n = 250,001 (PERF.md §5, NVIDIA H100 80GB HBM3):
# the minibatch fits' NLL/pt is reported beside it
PHASE3_ADAM_NLL_PP = 3.73391
MINI_NLL_REL = 0.02                  # minibatch NLL/pt within 2% of it
MINI_CRASH, MINI_EVERY = 120, 50


def _pooled(dev, D):
    """(tokens (n, L) int64 on the card, featurize, F = featurize(tokens))."""
    import torch

    n, L, _, _ = SELECT_CASES[D]
    if D == 2048:
        from repro_torch.configs import get_config
        from repro_torch.models.layers import init_embeddings

        table = init_embeddings(torch.Generator(device=dev).manual_seed(0),
                                get_config("tinyllama_1b"))["embed"].float()
    else:
        table = torch.randn((VOCAB, D), generator=torch.Generator(device=dev).manual_seed(1),
                            device=dev) * 0.05
    tokens = torch.randint(0, VOCAB, (n, L), generator=torch.Generator(device=dev).manual_seed(D),
                           device=dev)

    def featurize(t):
        return torch.nn.functional.embedding_bag(t.to(table.device).long(), table, mode="mean")

    return tokens, featurize, featurize(tokens)


def l2_float64_card(F):
    """Exact l2-only scores of features F in float64 on the card (Gram and
    projection there, eigh on the host): l2_float64 at widths the host
    cannot afford."""
    import numpy as np
    import torch

    F64 = F.double()
    w, V = np.linalg.eigh((F64.T @ F64).cpu().numpy())
    inv = np.where(w > 1e-6 * np.abs(w).max(), 1.0 / np.maximum(w, 1e-30), 0.0)
    Vt, it = torch.as_tensor(V, device=F.device), torch.as_tensor(inv, device=F.device)
    return (torch.square(F64 @ Vt) @ it).cpu().numpy() + 1.0 / F.shape[0]


def _plain_scoring():
    """Context: the scoring module's kernel wrappers replaced by their plain
    versions, on the card's tensors (the plain versions' selection)."""
    import contextlib

    from repro_torch.core import scoring
    from repro_torch.kernels.extremes.ref import directional_extremes_ref
    from repro_torch.kernels.gram.ref import gram_ref
    from repro_torch.kernels.sweep.ref import fused_sweep_ref

    @contextlib.contextmanager
    def ctx():
        real = (scoring.gram_matrix, scoring.fused_sweep_update, scoring.directional_extremes)
        scoring.gram_matrix = lambda X, sw=None, *, acc=None: gram_ref(X, sw, acc=acc)
        scoring.fused_sweep_update = fused_sweep_ref
        scoring.directional_extremes = directional_extremes_ref
        try:
            yield
        finally:
            scoring.gram_matrix, scoring.fused_sweep_update, scoring.directional_extremes = real

    return ctx()


def phase_kernels_wide_d(dev):
    """Phase 9's kernels, run beside phase 2, after the LM kernels' rows
    (profiler windows after phase 4 drop records): the gram kernel's large
    body (D > 160), the sweep at D > 160 and the wide-P route on one
    16,384-row chunk of the D = 2,048 pooled features: held to their plain versions (the sweep's SX' and z to
    the bit against the plain version on the CPU, whose index_add keeps each
    bucket's order), timed (events, device), gram in turns with
    torch.mm(X.T, X), the sweep with index_add_. Returns (kernel rows,
    records)."""
    import torch

    from repro_torch.core import scoring
    from repro_torch.core.scoring import sketch_plan, upfront_directions
    from repro_torch.kernels.extremes import ops as ext
    from repro_torch.kernels.extremes.ref import directional_extremes_ref
    from repro_torch.kernels.gram import ops as gram
    from repro_torch.kernels.gram.ref import gram_ref
    from repro_torch.kernels.sweep import ops as sweep
    from repro_torch.kernels.sweep.ref import fused_sweep_ref

    errs: list[str] = []
    _, _, F = _pooled(dev, 2048)
    n, D = CHUNK, F.shape[1]
    sk = SELECT_CASES[2048][3]
    X = F[:n].contiguous()
    sw = torch.ones(n, device=dev)
    gen = torch.Generator().manual_seed(90)
    acc = torch.randn(D, D, generator=gen).to(dev) * 1e-3
    rows, rec = [], {}
    # ---- gram, large body
    large0 = gram.PATH_LAUNCHES["large"]
    G = gram.gram_matrix(X, sw, acc=acc)
    Gr = gram_ref(X.double(), sw.double(), acc=acc.double())
    again = gram.gram_matrix(X, sw, acc=acc)
    torch.cuda.synchronize()
    err = max_err(G, Gr)
    scale = float(Gr.abs().max())
    if err > 1e-5 * scale or not torch.equal(G, again):
        errs.append(f"gram D={D} (large body): err {err} of max|G| {scale}, repeat equal "
                    f"{torch.equal(G, again)}")
    if gram.PATH_LAUNCHES["large"] - large0 != 2:
        errs.append("gram D=2048 did not take the large body")
    # its bound: its own instructions, three TF32 tensor-core products of
    # the upper triangle; the f32 FMA bound of the same Gram beside it
    nbytes = 4 * (n * D + n + 2 * D * D)
    r = kernel_row("gram_large", "src/repro_torch/csrc/gram.cu",
                   "src/repro/kernels/gram/kernel.py:30", err,
                   lambda: gram.gram_matrix(X, sw, acc=acc), lambda: gram_ref(X, sw, acc=acc),
                   lambda: torch.mm(X.T, X), nbytes=nbytes, flops=3 * n * D * (D + 1),
                   peak=H100_TF32_FLOPS)
    r["device_kernels_per_call"] = kernels_per_call(lambda: gram.gram_matrix(X, sw, acc=acc),
                                                    errs, "gram large body", 2, calls=5)
    rows.append(r)
    # the kernels line carries the TF32×3 bound alone; the f32 FMA bound and
    # the plan stay in the phase's record
    rec["gram_D2048"] = {"bound_tf32x3_ms": r["bound_ms"], "splits": gram.large_plan(n, D)[1],
                         "fma_bound_ms": bound_ms(nbytes, n * (D + D * (D + 1)))[0]}
    # the Gram of the rows [P, 1] (D 2,049: the wrapper pads it with zero
    # columns to the kernel's D 2,052), alone and as the wide-P route's
    # moments (_gram_moments), each in turns with torch.mm of its rows
    ones = torch.ones(n, 1, device=dev)
    X1 = torch.cat([X, ones], 1)
    Xp = torch.cat([X1, torch.zeros(n, 3, device=dev)], 1)
    s1, s2 = torch.zeros(D, device=dev), torch.zeros(D, D, device=dev)
    G1 = gram.gram_matrix(X1)
    mom = scoring._gram_moments(s1, s2, X)
    G1r = gram_ref(X1.double())
    torch.cuda.synchronize()
    err1 = max_err(G1, G1r)
    mom_err = max(max_err(mom[0], G1r[:D, D]), max_err(mom[1], G1r[:D, :D]))
    if (err1 > 1e-5 * float(G1r.abs().max()) or not torch.equal(G1, gram.gram_matrix(X1))
            or mom_err > 1e-5 * float(G1r.abs().max())):
        errs.append(f"gram of [P, 1]: err {err1}, moments err {mom_err}")
    for tag, call, Xl in (("gram_D2049", lambda: gram.gram_matrix(X1), X1),
                          ("gram_moments_D2052", lambda: scoring._gram_moments(s1, s2, X), Xp)):
        t = in_turns(call, lambda Xl=Xl: torch.mm(Xl.T, Xl))
        Dl = Xl.shape[1]
        t["bound_ms"], t["bound_by"] = bound_ms(4 * (n * Dl + 2 * Dl * Dl), 3 * n * Dl * (Dl + 1),
                                                H100_TF32_FLOPS)
        t["fma_bound_ms"] = bound_ms(4 * (n * Dl + 2 * Dl * Dl), n * Dl * (Dl + 1))[0]
        t["max_abs_err"] = err1 if Dl == D + 1 else mom_err
        rec[tag] = t
        log(f"  {tag}: device {t['device_ms']:.5f} ms vs torch.mm {t['library_device_ms']:.5f} ms "
            f"(in turns {[round(x, 5) for x in t['turns_device_ms']]}); events {t['ms']:.5f} vs "
            f"{t['library_ms']:.5f} ms; TF32x3 bound {t['bound_ms']:.5f} ms, f32 FMA bound "
            f"{t['fma_bound_ms']:.5f} ms")
    rec["gram D=161"] = {"err_rel": max_err(gram.gram_matrix(X[:, :161].contiguous()),
                                            gram_ref(X[:, :161].double())) / scale}
    # ---- the sweep at D = 2,048: the one-pass selector's chunk (no P rows)
    rws, sgn = sketch_plan(n, sk, generator=gen, device=dev)
    SX0 = torch.zeros(sk, D, device=dev)
    got = sweep.fused_sweep_update(SX0, X, None, sw, rws, sgn)
    plain = [t.to(dev) for t in fused_sweep_ref(SX0.cpu(), X.cpu(), None, sw.cpu(), rws.cpu(),
                                                sgn.cpu())[:2]]
    again = sweep.fused_sweep_update(SX0, X, None, sw, rws, sgn)
    torch.cuda.synchronize()
    err = max(max_err(got[0], plain[0]), max_err(got[1], plain[1]))
    bits = same_bits(got[0], plain[0]) and same_bits(got[1], plain[1])
    if not bits or not (same_bits(got[0], again[0]) and same_bits(got[1], again[1])):
        errs.append(f"sweep D={D} differs from its plain version's bits (err {err})")

    def library(SX0=SX0):
        return SX0.clone().index_add_(0, rws.long(), X * sgn[:, None])

    r = kernel_row("sweep_wide", "src/repro_torch/csrc/sweep.cu",
                   "src/repro/kernels/sweep/kernel.py:136", err,
                   lambda: sweep.fused_sweep_update(SX0, X, None, sw, rws, sgn),
                   lambda: fused_sweep_ref(SX0, X, None, sw, rws, sgn), library,
                   nbytes=4 * (2 * n * D + 2 * sk * D + 3 * n), flops=3 * n * D)
    # the front launch (the partition) and the tiles
    r["device_kernels_per_call"] = kernels_per_call(
        lambda: sweep.fused_sweep_update(SX0, X, None, sw, rws, sgn), errs, "sweep D=2048", 2,
        calls=5)
    log(f"  sweep D={D}: device {r['device_ms']:.5f} ms (parent "
        f"[{PARENT_DEVICE_MS['sweep D=2048']}]), {r['device_ms'] / r['library_device_ms']:.3f}× "
        f"index_add_, {r['bound_ms'] / r['device_ms']:.3f} of its bound; plan "
        f"{sweep.launch_plan(n, D, 1, 1, sk, 0, torch.cuda.get_device_properties(dev).multi_processor_count)}")
    rows.append(r)
    rec["sweep_D2048"] = _sweep_wide_cases(X, sw, rws, sgn, SX0, gen, errs)
    # ---- the wide-P route (P = X, d = 2,048) beside the sweep: one-pass
    # with the hull and the moments
    k2 = SELECT_K - int(SELECT_ALPHA * SELECT_K)
    dirs = torch.as_tensor(upfront_directions(D, k2, generator=gen), device=dev)

    def route():
        return scoring._sweep_update(SX0, X, X, sw, rws, sgn, dirs=dirs, moments=(s1, s2))

    w0, g0 = ext.PATH_LAUNCHES["wide"], gram.PATH_LAUNCHES["large"]
    out = route()
    ext_plain = directional_extremes_ref(X, dirs)
    X64 = X.double()
    torch.cuda.synchronize()
    ext_bits = all(same_bits(a, b) for a, b in zip(out[2], ext_plain))
    mom_err = max(max_err(out[3][0], X64.sum(0)), max_err(out[3][1], X64.T @ X64))
    if not ext_bits or not (close(out[3][0], X64.sum(0), rtol=1e-6, atol=1e-4)
                            and close(out[3][1], X64.T @ X64, rtol=1e-6, atol=1e-4)):
        errs.append(f"the wide-P route disagrees: extremes bits {ext_bits}, moments {mom_err}")
    if ext.PATH_LAUNCHES["wide"] - w0 != 1 or gram.PATH_LAUNCHES["large"] - g0 != 1:
        errs.append("the wide-P route did not take the extremes wide body and gram's large body")
    m = dirs.shape[0]
    b, by = bound_ms(4 * (n * D + m * D + 2 * sk * D + 2 * n * D + D * D),
                     2 * m * n * D + 2 * n * D * (D + 1))
    rec["wide_p_route"] = {
        "dirs": m, "ms": cuda_ms(route, iters=5, warmup=1), "device_ms": device_ms(route, 5),
        "bound_ms": b, "bound_by": by, "extremes_bits": ext_bits, "moments_err": mom_err,
        "plain_ms": cuda_ms(lambda: (fused_sweep_ref(SX0, X, None, sw, rws, sgn),
                                     directional_extremes_ref(X, dirs), gram_ref(X)),
                            iters=1, warmup=0)}
    # the route's extremes against the one PyTorch call pair that computes
    # them: dirs @ P.T, then max and min
    def library_extremes():
        S = dirs @ X.T
        return S.max(dim=1), S.min(dim=1)

    # CUDA events alone: every profiler window of these 35-ms calls lost a
    # kernel record, and at that length the events read the device time
    turns = [cuda_ms(f, iters=5, warmup=1) for f in (
        lambda: ext.directional_extremes(X, dirs), library_extremes, library_extremes,
        lambda: ext.directional_extremes(X, dirs))]
    rec["wide_p_route"]["extremes_in_turns"] = {
        "ms": (turns[0] + turns[3]) / 2, "library_ms": (turns[1] + turns[2]) / 2,
        "turns_ms": turns, "ratio": (turns[0] + turns[3]) / (turns[1] + turns[2]),
        "plan": ext.wide_launch_plan(n, m, torch.cuda.get_device_properties(dev)
                                     .multi_processor_count)._asdict(),
        "bound_ms": bound_ms(4 * (n * D + m * D + 4 * m), 2 * m * n * D)[0]}
    # the route's time by kernel: the sweep (its row above, the same call),
    # the extremes (events, above) and the moments' Gram (device, above)
    rec["wide_p_route"]["split_ms"] = {
        "sweep": rows[-1]["device_ms"], "extremes": rec["wide_p_route"]["extremes_in_turns"]["ms"],
        "gram_moments": rec["gram_moments_D2052"]["device_ms"]}
    log(f"  the wide-P route at d = {D} ({m:,} directions): {json.dumps(rec['wide_p_route'])}")
    if errs:
        fail("phase 9 kernels: " + "; ".join(errs))
    return rows, rec


SWEEP_WIDE_Q = 256          # Ω's columns in phase 9's D = 2,048 sweep with Ω
SWEEP_WIDE_P = (7, 1614)    # P rows' width and directions in the one with P rows


def _sweep_wide_cases(X, sw, rws, sgn, SX0, gen, errs) -> dict:
    """The sweep at D = 2,048 with Ω (q = SWEEP_WIDE_Q: the block CTAs write
    z) and with P rows (d = 7 beside 1,614 directions and the moments: the
    block CTAs and the fold), each held to the plain version's bits (SX' on
    the CPU; z = √w·X or fma_matmul's chain, the extremes, on the card,
    elementwise or dense as on the CPU), the moments within rtol 1e-6 /
    atol 1e-4 of float64, a repeated call to the same bits; then the three
    calls timed in turns by device ms (none, Ω, P, P, Ω, none), with their
    device kernels a call and bounds."""
    import torch

    from repro_torch.kernels.extremes.ref import directional_extremes_ref, fma_matmul
    from repro_torch.kernels.sweep import ops as sweep
    from repro_torch.kernels.sweep.ref import fused_sweep_ref

    n, D = X.shape
    sk = SX0.shape[0]
    q, (d, m) = SWEEP_WIDE_Q, SWEEP_WIDE_P
    dev = X.device
    omega = (torch.randn(D, q, generator=gen) / D ** 0.5).to(dev)
    P = torch.randn(n, d, generator=gen).to(dev)
    dirs = torch.randn(m, d, generator=gen).to(dev)
    mom = (torch.zeros(d, device=dev), torch.zeros(d, d, device=dev))
    calls = {
        "none": lambda: sweep.fused_sweep_update(SX0, X, None, sw, rws, sgn),
        "omega": lambda: sweep.fused_sweep_update(SX0, X, None, sw, rws, sgn, omega=omega),
        "p_rows": lambda: sweep.fused_sweep_update(SX0, X, P, sw, rws, sgn, dirs=dirs,
                                                   moments=mom),
    }
    sx_plain = fused_sweep_ref(SX0.cpu(), X.cpu(), None, sw.cpu(), rws.cpu(), sgn.cpu(),
                               want_z=False)[0].to(dev)
    Xw = X * sw[:, None]
    plain_z = {"omega": fma_matmul(Xw, omega), "p_rows": Xw}
    ext_plain = directional_extremes_ref(P, dirs)
    P64 = P.double()
    mom64 = (P64.sum(0), P64.T @ P64)
    out = {}
    for tag in ("omega", "p_rows"):
        got, again = calls[tag](), calls[tag]()
        torch.cuda.synchronize()
        flat = lambda o: [o[0], o[1], *(o[2] or ()), *(o[3] or ())]  # noqa: E731
        res = {"sx_bits": same_bits(got[0], sx_plain), "z_bits": same_bits(got[1], plain_z[tag]),
               "z_elements_differ": int((got[1].view(torch.int32)
                                         != plain_z[tag].view(torch.int32)).sum()),
               "repeat_bits": all(same_bits(a, b) for a, b in zip(flat(got), flat(again))),
               "max_abs_err": max(max_err(got[0], sx_plain), max_err(got[1], plain_z[tag]))}
        ok = res["sx_bits"] and res["z_bits"] and res["repeat_bits"]
        if tag == "p_rows":
            res["extremes_bits"] = all(same_bits(a, b) for a, b in zip(got[2], ext_plain))
            res["moments_err"] = max(max_err(a, b) for a, b in zip(got[3], mom64))
            ok = ok and res["extremes_bits"] and all(
                close(a, b, rtol=1e-6, atol=1e-4) for a, b in zip(got[3], mom64))
        if not ok:
            errs.append(f"sweep D={D} with {tag} disagrees with its plain version: {res}")
        out[tag] = res
    order = ("none", "omega", "p_rows", "p_rows", "omega", "none")
    turns = [device_ms(calls[k], 5) for k in order]
    for i, tag in enumerate(("none", "omega", "p_rows")):
        rec = out.setdefault(tag, {})
        rec["device_ms"] = (turns[i] + turns[5 - i]) / 2
        rec["ms"] = cuda_ms(calls[tag], iters=5, warmup=1)
        want = {"none": 2, "omega": 2, "p_rows": 3}[tag]
        rec["device_kernels_per_call"] = kernels_per_call(calls[tag], errs, f"sweep D={D} {tag}",
                                                          want, calls=5)
    io = 2 * n * D + 2 * sk * D + 3 * n  # X, z, SX read and written, sw, rows, signs
    out["none"]["bound_ms"], out["none"]["bound_by"] = bound_ms(4 * io, 3 * n * D)
    out["omega"]["bound_ms"], out["omega"]["bound_by"] = bound_ms(
        4 * (io - n * D + n * q + D * q), 2 * n * D * q + 2 * n * D)
    out["p_rows"]["bound_ms"], out["p_rows"]["bound_by"] = bound_ms(
        4 * (io + n * d + m * d + 4 * m), 3 * n * D + 2 * m * n * d + n * d * (d + 3))
    out["turns_device_ms"] = turns
    log(f"  sweep D={D} beside Ω (q = {q}) and P rows (d = {d}, {m:,} directions): "
        f"{json.dumps(out)}")
    return out


def _phase9_select(dev, census, errs):
    """CoresetSelector (l2-hull, k = 2,048, α = 0.8) at D = 32 and 2,048,
    two-pass and one-pass, on the card's kernels, against float64 of the
    same features (with the controls that must fail), the plain versions'
    selection on the card and Σ weights against n."""
    import numpy as np
    import torch

    from repro_torch.core import scoring
    from repro_torch.core.scoring import ScoringEngine, sketch_plan
    from repro_torch.data.pipeline import CoresetSelector

    k2 = SELECT_K - int(SELECT_ALPHA * SELECT_K)
    k1 = SELECT_K - k2
    rec = {}
    for D, (n, L, chunk, sketch) in SELECT_CASES.items():
        tokens, featurize, F = _pooled(dev, D)
        look = lookup_featurizer(F, F, dev)
        index = torch.stack([torch.arange(n, device=dev, dtype=torch.float32),
                             torch.zeros(n, device=dev)], 1)
        for strategy, sk in (("two-pass", 0), ("one-pass", sketch)):
            tag = f"select D={D} {strategy}"
            gen = torch.Generator().manual_seed(D + sk)
            plan = {"hull_normals": torch.randn(4 * k2, D, generator=gen).numpy()}
            if sk:
                plan["sketch"] = sketch_plan(n, sk, generator=gen, device=dev)
            results = []

            def run(sel, seed):
                real = sel._engine.score

                def keep(*a, **kw):
                    results.append(real(*a, **kw))
                    return results[-1]

                sel._engine.score = keep
                return sel.select(tokens, SELECT_K, generator=torch.Generator().manual_seed(seed),
                                  plan=plan)

            sel = CoresetSelector(featurize, sketch_size=sk, chunk_size=chunk, device=dev)
            _sync()
            reset_counts()
            t0 = time.perf_counter()
            sub = run(sel, 7)
            _sync()
            select_s = time.perf_counter() - t0
            census[tag] = read_counts()
            scores = results[-1].scores

            def engine_scores(feat, gram_dtype="float32"):
                kw = dict(method="l2-only", hull_k=0, sketch_size=sk)
                if sk:
                    kw["plan"] = plan["sketch"]
                return ScoringEngine(featurize=feat, chunk_size=chunk, rows_per_point=1,
                                     gram_dtype=gram_dtype, device=dev).score(index, **kw).scores

            t0 = time.perf_counter()
            ref = engine_scores(look, "float64") if sk else l2_float64_card(F)
            ref_s = time.perf_counter() - t0
            if sk:
                control = engine_scores(lookup_featurizer(F, F, dev, dtype=torch.bfloat16))
                control_name = "bf16 features"
            else:
                real = scoring.gram_matrix
                scoring.gram_matrix = _tf32_gram
                try:
                    control = engine_scores(look)
                finally:
                    scoring.gram_matrix = real
                control_name = "TF32 Gram"
            err, cerr = rel_err(scores, ref), rel_err(control, ref)
            with _plain_scoring():
                t0 = time.perf_counter()
                plain = run(CoresetSelector(featurize, sketch_size=sk, chunk_size=chunk,
                                            device=dev), 7)
                _sync()
                plain_s = time.perf_counter() - t0
            hull, hull_plain = sub.indices[k1:], plain.indices[k1:]
            r = {"n": n, "D": D, "sketch": sk, "chunk": chunk, "select_s": select_s,
                 "plain_select_s": plain_s, "float64_s": ref_s,
                 "scores_rel_err_float64": err, f"control_{control_name}": cerr,
                 "hull_common": int(np.intersect1d(hull, hull_plain).size), "hull_k": k2,
                 "sampled_same": int((sub.indices[:k1] == plain.indices[:k1]).sum()),
                 "plain_scores_rel_err_float64": rel_err(results[-1].scores, ref),
                 "weights_sum_rel_n": abs(float(sub.weights.sum()) - n) / n,
                 "distinct_hull": int(np.unique(hull).size), "launches": census[tag]}
            rec[tag] = r
            log(f"phase 9 {tag}: {json.dumps(r)}")
            lim = SELECT_SCORE_RTOL[strategy]
            if not err <= lim or not cerr > lim:
                errs.append(f"{tag}: scores {err} from float64 (limit {lim}); "
                            f"the {control_name} control {cerr} must exceed it")
            if r["hull_common"] < SELECT_HULL_COMMON_FLOOR * k2 or r["distinct_hull"] != k2:
                errs.append(f"{tag}: hull ids {r['hull_common']} of {k2} shared with the plain "
                            f"versions', {r['distinct_hull']} distinct")
            if sub.size != SELECT_K or not np.all(sub.weights > 0):
                errs.append(f"{tag}: {sub.size} ids, weights positive {np.all(sub.weights > 0)}")
        del tokens, F
        torch.cuda.empty_cache()
    return rec


def _phase9_minibatch(dev, scratch, census, errs):
    """The minibatch fit on the J = 2 path (n = 250,001, batch 4,096, 250
    steps) in both sampling modes, NLL/pt beside phase 3's adam full fit;
    then every draw past a straggler deadline (backup draws), and a crash at
    step 120 recovered from the step-100 checkpoint to the straight run's
    bits."""
    import numpy as np
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import mctm as M
    from repro_torch.core.bernstein import DataScaler
    from repro_torch.core.mctm_fit import fit_mctm_streaming, streamed_nll
    from repro_torch.data.dgp import generate
    from repro_torch.ft import FailureSimulator, get_ft_config

    cfg = M.MCTMConfig(J=2, degree=6)
    Yn = generate("normal_mixture", MAIN_N, seed=0).astype(np.float32)
    scaler = DataScaler.fit(Yn)
    init = M.init_params(cfg, generator=torch.Generator().manual_seed(91), device=dev)
    rec, fits = {}, {}

    def fit(tag, sampling="uniform", **kw):
        _sync()
        reset_counts()
        t0 = time.perf_counter()
        out = fit_mctm_streaming(cfg, scaler, Yn, init=init, steps=MINI_STEPS,
                                 method="minibatch", batch_size=MINI_BATCH, sample_seed=3,
                                 sampling=sampling, chunk_size=CHUNK, device=dev, **kw)
        _sync()
        s = time.perf_counter() - t0
        census[f"minibatch {tag}"] = read_counts()
        nll = streamed_nll(cfg, scaler, out.params, Yn, chunk=CHUNK, eta=1e-9, device=dev) / MAIN_N
        rec[tag] = {"fit_s": s, "nll_pp": nll, "ratio_to_adam_full": nll / PHASE3_ADAM_NLL_PP,
                    "final_loss": float(out.losses[-1]),
                    "bernstein": census[f"minibatch {tag}"]["bernstein"]}
        log(f"phase 9 minibatch {tag}: {json.dumps(rec[tag])}")
        fits[tag] = out
        return out

    for sampling in ("uniform", "importance"):
        fit(sampling, sampling)
        if abs(rec[sampling]["ratio_to_adam_full"] - 1) > MINI_NLL_REL:
            errs.append(f"minibatch {sampling}: NLL/pt {rec[sampling]['nll_pp']} against "
                        f"{PHASE3_ADAM_NLL_PP}")
    ft = get_ft_config()
    old = ft.straggler_deadline_ms
    ft.straggler_deadline_ms = 1e-6  # no draw meets it: every step takes its backup draw
    try:
        fit("backup draws")
    finally:
        ft.straggler_deadline_ms = old
    if np.array_equal(fits["backup draws"].losses, fits["uniform"].losses):
        errs.append("the straggler deadline took no backup draw")
    d = os.path.join(scratch, "minibatch")
    ft.simulator = sim = FailureSimulator().inject("fit", MINI_CRASH)
    try:
        fit("crash at 120", checkpoint=CheckpointManager(d), ckpt_every=MINI_EVERY)
    finally:
        ft.simulator = None
    same = all(torch.equal(a, b) for a, b in zip(
        (fits["crash at 120"].params.theta_raw, fits["crash at 120"].params.lam),
        (fits["uniform"].params.theta_raw, fits["uniform"].params.lam)))
    rec["crash at 120"]["same_bits"] = same
    rec["crash at 120"]["injections"] = list(sim.failures)
    if not same or sim.failures != [MINI_CRASH]:
        errs.append(f"the crashed minibatch fit did not recover the straight bits: {sim.failures}")
    return rec


def phase_pipeline(dev, scratch: str):
    """Phase 9: the data pipeline (CoresetSelector at D = 32 and 2,048) and
    the minibatch fit (its kernels ran beside phase 2:
    ``phase_kernels_wide_d``). Returns (census, records)."""
    errs: list[str] = []
    census: dict = {}
    rec = {}
    rec["select"] = _phase9_select(dev, census, errs)
    rec["minibatch"] = _phase9_minibatch(dev, scratch, census, errs)
    need = {"select D=32 two-pass": ("gram", "extremes_wide"),
            "select D=32 one-pass": ("sweep", "extremes_wide"),
            "select D=2048 two-pass": ("gram_large", "extremes_wide"),
            "select D=2048 one-pass": ("sweep_wide", "extremes_wide"),
            "minibatch uniform": ("bernstein",), "minibatch importance": ("bernstein",)}
    for path, counts in census.items():
        log(f"census {path}: {json.dumps(counts)}")
        for name in need.get(path, ()):
            if counts.get(name, 0) <= 0:
                errs.append(f"{name} was not launched on the {path} path")
    if errs:
        fail("phase 9: " + "; ".join(errs))
    return census, rec


# ---------------------------------------------------------------- phase 10

SERVE_ARGV = ["--device", "cuda"]   # serve_mctm at its defaults
DRIFT_SERVE_CLEAN, DRIFT_SERVE_SHIFTED = 6, 8


def phase_serving(dev):
    """Phase 10: ``launch/serve_mctm.py`` at its defaults (n = 200,000,
    k = 1,000, 200 steps, chunk 16,384, 4,096 queries of which 25% are
    conditional samples, max batch 256, min bucket 8) with its gates; then
    the streaming maintainer with ``serve_engine=`` and ``auto_trigger`` on
    phase 8's clean-then-shifted stream: drift fires, a refit publishes, the
    detector re-anchors and the served NLL of the shifted windows falls back
    into its band. Returns (census, records)."""
    import numpy as np
    import torch

    from repro_torch.core import mctm as M
    from repro_torch.core.bernstein import DataScaler
    from repro_torch.core.mctm_fit import fit_mctm_streaming
    from repro_torch.core.streaming import DriftDetector, StreamingCoresetMaintainer
    from repro_torch.data.dgp import generate
    from repro_torch.launch import serve_mctm
    from repro_torch.serve.density import DensityServeEngine

    errs: list[str] = []
    census: dict = {}
    rec: dict = {}
    reset_counts()
    t0 = time.perf_counter()
    sv = serve_mctm.run(serve_mctm.parse_args(SERVE_ARGV))
    sv["s"] = time.perf_counter() - t0
    census["serve_mctm"] = read_counts()
    census["serve_mctm"]["bernstein (graph replays)"] = sv["replayed_launches"].get("bernstein", 0)
    rec["serve_mctm"] = {k: v for k, v in sv.items() if k != "stats"}
    rec["serve_mctm"]["ticks"] = sv["stats"]["ticks"]
    log(f"phase 10 serve_mctm: {json.dumps(rec['serve_mctm'])}")
    if (sv["dropped"] or sv["mixed_version_answers"] or sv["captures_after_warmup"]
            or sv["log_density_max_err"] > serve_mctm.LOG_DENSITY_ATOL
            or not set(sv["versions_served"]) >= {0, 1}
            or sv["replayed_launches"].get("bernstein", 0) <= 0):
        errs.append(f"serve_mctm: {rec['serve_mctm']}")

    # ---- the drift → refit → publish loop
    cfg = M.MCTMConfig(J=2, degree=6)
    n = STREAM_WINDOWS * STREAM_ROWS
    Yn = generate("normal_mixture", n, seed=1).astype(np.float32)
    scaler = DataScaler.fit(Yn)
    windows = [Yn[i * STREAM_ROWS:(i + 1) * STREAM_ROWS] for i in range(STREAM_WINDOWS)]
    fit2 = fit_mctm_streaming(cfg, scaler, np.concatenate(windows[:2]),
                              generator=torch.Generator().manual_seed(34), steps=FT_STEPS,
                              method="adam", chunk_size=STREAM_ROWS, device=dev)
    eng = DensityServeEngine(cfg, fit2.params, scaler, device=dev)
    eng.warmup(kinds=("log_density",))
    m = StreamingCoresetMaintainer(cfg, scaler, STREAM_K, 31, alpha=STREAM_ALPHA,
                                   policy="sliding", window=2, sketch_size=SKETCH,
                                   serve_engine=eng, detector=DriftDetector(),
                                   refit_kwargs=dict(method="lbfgs", steps=60,
                                                     chunk_size=CHUNK), device=dev)
    std = Yn.std(0)
    reset_counts()
    t0 = time.perf_counter()
    waits = []
    for i in range(DRIFT_SERVE_CLEAN + DRIFT_SERVE_SHIFTED):
        w = windows[2 + i]
        if i >= DRIFT_SERVE_CLEAN:
            w = w * 1.6 + 2 * std
        m.push(w)
        if m.drift_log[-1]["triggered"]:
            t1 = time.perf_counter()
            while eng.refit_in_flight:
                time.sleep(0.01)
            waits.append(time.perf_counter() - t1)
        eng.submit_log_density(w[:64])  # probe traffic: the publish swaps in at a tick
        eng.run_until_drained()
    loop_s = time.perf_counter() - t0
    census["drift loop"] = read_counts()
    log_ = m.drift_log
    fired = [e["window"] for e in log_ if e["fired"]]
    after = [e for e in log_ if e["version"] >= 1]
    rec["drift_loop"] = {
        "windows": [{k: e[k] for k in ("window", "version", "nll_pp", "ewma", "fired",
                                       "triggered")} for e in log_],
        "fired": fired, "refits": eng.refit_log, "triggered": m.triggered,
        "refit_wait_s": waits, "s": loop_s, "final_eps_hat": log_[-1]["eps_hat"],
        "versions": sorted({e["version"] for e in log_}), "captures": eng.compile_count}
    log(f"phase 10 drift loop: {json.dumps(rec['drift_loop'])}")
    if (any(e["fired"] for e in log_[:DRIFT_SERVE_CLEAN]) or not fired
            or not eng.refit_log or not after or not after[-1]["eps_hat"] <= 0.1
            or eng.compile_count != len(eng.buckets)):
        errs.append(f"the drift → refit loop did not close: fired {fired}, refits "
                    f"{len(eng.refit_log)}, final eps_hat {log_[-1]['eps_hat']}")
    need = {"serve_mctm": ("bernstein", "gram", "extremes"), "drift loop": ("bernstein", "sweep")}
    for path, counts in census.items():
        log(f"census {path}: {json.dumps(counts)}")
        for name in need.get(path, ()):
            if counts.get(name, 0) <= 0:
                errs.append(f"{name} was not launched on the {path} path")
    if errs:
        fail("phase 10: " + "; ".join(errs))
    return census, rec


# ---------------------------------------------------------------- phase 11

MESH_WORLDS = (2, 4)                 # gloo ranks sharing the one card
MESH_STEPS = 250                     # the world-1 adam fit, as phase 3's
MESH_F64_ATOL = 1e-6                 # f64-Gram scores, world R against world 1
# the f32 default's two-pass ridge-lss scores against float64 of the same
# features (relative). Not l2: the degree-6 Gram's pseudo-inverse turns any
# f32 summation order, a shard split included, into 3e-3–6e-3 of float64
# (Queue C 2), and a TF32 Gram reads 5.2e-3 there on the H100, so no l2
# limit separates a TF32 Gram (l2 is reported beside it). With ridge 1 the
# H100 reads 1.28e-4 (world 1), 3.25e-4 (2), 1.41e-4 (4), the TF32-Gram
# control 5.12e-4 at world 1: every one the same bits on every run. The
# TF32 control runs at every world, each held to this limit, and a
# bf16-feature control at world 1 lies far beyond it.
MESH_F32_RTOL = 4e-4
MESH_SEG_EVERY = 4                   # sweep_ckpt_every_chunks on the mesh
MESH_SEG_CRASH = 6                   # maybe_inject("scoring", 6): rank chunk 6 of sweep 1


def _mesh_gen(*parts):
    import numpy as np
    import torch

    return torch.Generator().manual_seed(int(np.random.SeedSequence(parts).generate_state(1)[0]))


def mesh_rank(mesh, Y, scratch):
    """One rank of phase 11's gloo worlds, on the shared card: the
    f64-Gram and f32 two-pass scores (l2-only, ridge-lss, and ridge-lss on a
    TF32 Gram, the control), each strategy's builds at k = 500 and 2000
    (their census, build_s and fold bytes), and at world 2 a segmented sweep
    crashed at chunk 6 and resumed. Returns what the parent checks; every
    rank returns its own."""
    import copy

    import numpy as np
    import torch

    from repro_torch.core import distributed_coreset as TD
    from repro_torch.core import mctm as M
    from repro_torch.core import scoring
    from repro_torch.core.bernstein import DataScaler
    from repro_torch.ft import FailureSimulator, get_ft_config

    def sync():
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)

    reset_counts()
    cfg = M.MCTMConfig(J=2, degree=6)
    scaler = DataScaler.fit(Y)
    out = {"rank": mesh.rank, "device": str(mesh.device), "backend": mesh.backend}
    f64 = TD.DistributedScoringEngine(cfg, scaler, mesh=mesh, chunk_size=CHUNK,
                                      gram_dtype="float64")
    out["f64"] = f64.score(Y, method="l2-only").scores
    eng = TD.DistributedScoringEngine(cfg, scaler, mesh=mesh, chunk_size=CHUNK)
    out["f32"] = eng.score(Y, method="l2-only").scores
    out["f32_ridge"] = eng.score(Y, method="ridge-lss").scores
    gram_kernel = scoring.gram_matrix
    scoring.gram_matrix = _tf32_gram  # every rank's partial Gram, then the fold
    try:
        out["tf32_ridge"] = eng.score(Y, method="ridge-lss").scores
    finally:
        scoring.gram_matrix = gram_kernel
    builds = {}
    for strategy, sketch in (("two-pass", 0), ("one-pass", SKETCH)):
        for k in KS:
            mesh.reset_census()
            sync()
            t0 = time.perf_counter()
            cs = TD.distributed_build_coreset(cfg, scaler, Y, k, mesh=mesh, chunk_size=CHUNK,
                                              sketch_size=sketch,
                                              generator=_mesh_gen(0, k, sketch))
            sync()
            builds[f"{strategy} k={k}"] = {"build_s": time.perf_counter() - t0,
                                           "indices": cs.indices, "weights": cs.weights,
                                           "census": copy.deepcopy(mesh.census)}
    out["builds"] = builds
    if mesh.world == 2:
        ft = get_ft_config()
        ft.sweep_ckpt_every_chunks = MESH_SEG_EVERY
        seg = {}
        for strategy, kw in (("two-pass", {}), ("one-pass", {"sketch_size": SKETCH})):
            def score(sub, resume=False):
                return eng.score(Y, method="l2-hull", hull_k=400, generator=_mesh_gen(1, 400),
                                 sweep_ckpt=os.path.join(scratch, sub), resume=resume, **kw)

            t0 = time.perf_counter()
            straight = score(f"{strategy}-straight")
            straight_s = time.perf_counter() - t0
            ft.simulator = sim = FailureSimulator().inject("scoring", MESH_SEG_CRASH)
            try:
                score(f"{strategy}-crash")
                crashed = False
            except RuntimeError:
                crashed = True
            finally:
                ft.simulator = None
            resumed = score(f"{strategy}-crash", resume=True)
            seg[strategy] = {
                "crashed_at": [e["step"] for e in sim.log] if crashed else [],
                "same_bits": bool(np.array_equal(straight.scores, resumed.scores)
                                  and np.array_equal(straight.hull_rows, resumed.hull_rows)
                                  and np.array_equal(straight.gram, resumed.gram)),
                "straight_s": straight_s}
        ft.sweep_ckpt_every_chunks = 4
        out["segmented"] = seg
    out["launches"] = read_counts()
    return out


def phase_mesh(dev, scratch: str):
    """Phase 11: Algorithm 1 on the data mesh at the path's width
    (normal_mixture, n = 250,001, J = 2, degree 6, chunk 16,384, k = 500
    and 2000, two-pass and one-pass at sketch 784).

    (a) World 1 on NCCL (a process group of one rank): every collective is
        the identity, so ``distributed_build_coreset``, ``streamed_nll(mesh=)``
        and the adam fit (250 steps) must give the single-device calls' bits.
    (b) Worlds 2 and 4 on gloo, their ranks spawned on the one card (NCCL
        takes one rank a GPU; gloo stages each fold's buffer through the
        host): the f64-Gram scores within MESH_F64_ATOL of world 1's, the f32
        two-pass ridge-lss scores within MESH_F32_RTOL of float64 of the same
        features (a TF32-Gram control at each world, and a bf16-feature
        control at world 1, must fail that limit; the l2 scores' distance
        reported), every rank's coreset ids
        and weights the same bits, one fold a sweep and one gather pair for
        the hull, per-rank build_s and fold bytes printed.
    (c) At world 2, a segmented sweep crashed at chunk 6 and resumed to the
        uninterrupted bits, both strategies.

    Returns (census, records)."""
    import numpy as np
    import torch

    from repro_torch.core import mctm as M
    from repro_torch.core import scoring
    from repro_torch.core.bernstein import DataScaler
    from repro_torch.core.coreset import build_coreset
    from repro_torch.core.distributed_coreset import DistributedScoringEngine, distributed_build_coreset
    from repro_torch.core.mctm_fit import fit_mctm_streaming, streamed_nll
    from repro_torch.data.dgp import generate
    from repro_torch.distributed import init_mesh, run_world

    errs: list[str] = []
    census: dict = {}
    rec: dict = {"world1": {}, "worlds": {}}
    cfg = M.MCTMConfig(J=2, degree=6)
    Y = generate("normal_mixture", MAIN_N, seed=0).astype(np.float32)
    scaler = DataScaler.fit(Y)
    os.makedirs(scratch, exist_ok=True)

    # ---- (a) world 1 on NCCL
    t0 = time.perf_counter()
    mesh = init_mesh(0, 1, backend="nccl", device=dev,
                     init_method="file://" + os.path.join(scratch, "nccl_store"))
    log(f"phase 11 world 1: NCCL group of one rank up in {time.perf_counter() - t0:.2f}s")
    try:
        same = {}
        for strategy, sketch in (("two-pass", 0), ("one-pass", SKETCH)):
            for k in KS:
                reset_counts()
                _sync()
                t0 = time.perf_counter()
                a = distributed_build_coreset(cfg, scaler, Y, k, mesh=mesh, chunk_size=CHUNK,
                                              sketch_size=sketch, generator=_mesh_gen(0, k, sketch))
                _sync()
                mesh_s = time.perf_counter() - t0
                census[f"world 1 nccl {strategy} k={k}"] = read_counts()
                t0 = time.perf_counter()
                b = build_coreset(cfg, scaler, Y, k, chunk_size=CHUNK, sketch_size=sketch,
                                  generator=_mesh_gen(0, k, sketch), device=dev)
                _sync()
                same[f"{strategy} k={k}"] = {
                    "same_bits": bool(np.array_equal(a.indices, b.indices)
                                      and np.array_equal(a.weights, b.weights)),
                    "build_s": mesh_s, "single_build_s": time.perf_counter() - t0}
        p0 = M.init_params(cfg, generator=_mesh_gen(2), device=dev)
        nll_mesh = streamed_nll(cfg, scaler, p0, Y, chunk=CHUNK, eta=1e-9, mesh=mesh)
        nll_one = streamed_nll(cfg, scaler, p0, Y, chunk=CHUNK, eta=1e-9, device=dev)
        fits = {}
        for tag, kw in (("mesh", {"mesh": mesh}), ("single", {"device": dev})):
            _sync()
            t0 = time.perf_counter()
            fits[tag] = fit_mctm_streaming(cfg, scaler, Y, init=p0, steps=MESH_STEPS,
                                           method="adam", chunk_size=CHUNK, **kw)
            _sync()
            fits[tag + "_s"] = time.perf_counter() - t0
        fit_same = bool(np.array_equal(fits["mesh"].losses, fits["single"].losses) and all(
            np.array_equal(x, y) for x, y in zip(M.params_to_numpy(fits["mesh"].params),
                                                 M.params_to_numpy(fits["single"].params))))
        rec["world1"] = {"builds": same, "nll_same": nll_mesh == nll_one,
                         "nll_pp": nll_mesh / MAIN_N, "fit_same_bits": fit_same,
                         "fit_s": fits["mesh_s"], "single_fit_s": fits["single_s"],
                         "fit_nll_pp": fits["mesh"].final_nll / MAIN_N,
                         "collectives": dict(mesh.census)}
        log("phase 11 world 1 (nccl): " + json.dumps(rec["world1"]))
        if not all(v["same_bits"] for v in same.values()) or not rec["world1"]["nll_same"] \
                or not fit_same or mesh.census:
            errs.append(f"world 1 on NCCL is not the single-device run: {rec['world1']}")
        # world 1's f64 and f32 scores, the float64 of the features and the TF32 control
        w1_f64 = DistributedScoringEngine(cfg, scaler, mesh=mesh, chunk_size=CHUNK,
                                          gram_dtype="float64").score(Y, method="l2-only").scores
        w1_eng = DistributedScoringEngine(cfg, scaler, mesh=mesh, chunk_size=CHUNK)
        w1_f32 = w1_eng.score(Y, method="l2-only").scores
        w1_ridge = w1_eng.score(Y, method="ridge-lss").scores
        X = scoring._mctm_featurize(cfg, scaler)(torch.as_tensor(Y, device=dev))[0]
        exact = l2_float64_card(X)
        X64 = X.double()
        w_, V_ = np.linalg.eigh((X64.T @ X64).cpu().numpy())
        Vt = torch.as_tensor(V_, device=dev)
        inv_r = torch.as_tensor(1.0 / (np.maximum(w_, 0.0) + 1.0), device=dev)
        exact_ridge = (torch.square(X64 @ Vt) @ inv_r).cpu().numpy() + 1.0 / MAIN_N
        del X, X64
        gram_kernel = scoring.gram_matrix
        scoring.gram_matrix = _tf32_gram
        try:
            tf32 = w1_eng.score(Y, method="l2-only").scores
            tf32_ridge = w1_eng.score(Y, method="ridge-lss").scores
        finally:
            scoring.gram_matrix = gram_kernel
        featurize = scoring._mctm_featurize(cfg, scaler)

        def bf16_features(Yc):
            Xc, Pc = featurize(Yc)
            return Xc.bfloat16().float(), Pc

        bf16 = DistributedScoringEngine(featurize=bf16_features, rows_per_point=cfg.J, mesh=mesh,
                                        chunk_size=CHUNK).score(Y, method="ridge-lss").scores
        controls = {"TF32 Gram": rel_err(tf32_ridge, exact_ridge),
                    "bf16 features": rel_err(bf16, exact_ridge)}
        rec["world1"].update(f32_vs_float64=rel_err(w1_ridge, exact_ridge), controls=controls,
                             l2_f32_vs_float64=rel_err(w1_f32, exact),
                             l2_tf32_vs_float64=rel_err(tf32, exact))
        log(f"phase 11 world 1: ridge-lss f32 vs float64 {rec['world1']['f32_vs_float64']:.3e}, "
            f"controls {json.dumps(controls)} (limit {MESH_F32_RTOL}); l2 (reported) f32 "
            f"{rec['world1']['l2_f32_vs_float64']:.3e}, TF32 {rec['world1']['l2_tf32_vs_float64']:.3e}")
        if rec["world1"]["f32_vs_float64"] > MESH_F32_RTOL:
            errs.append(f"world 1: ridge-lss scores {rec['world1']['f32_vs_float64']} from float64")
        for name, value in controls.items():
            if value <= MESH_F32_RTOL:
                errs.append(f"MESH_F32_RTOL does not separate the {name} control: {value}")
    finally:
        mesh.close()

    # ---- (b) and (c): gloo worlds on the shared card
    from repro_torch.kernels import _lib

    if dev.type == "cuda":
        _lib.lib()  # built by this process; the ranks load it
    for world in MESH_WORLDS:
        t0 = time.perf_counter()
        ranks = run_world(mesh_rank, world, backend="gloo", devices=[dev] * world,
                          args=(Y, os.path.join(scratch, f"world{world}")), timeout_s=600)
        wall = time.perf_counter() - t0
        r0 = ranks[0]
        w = {"wall_s": wall, "f64_vs_world1": float(np.abs(r0["f64"] - w1_f64).max()),
             "f32_vs_float64": rel_err(r0["f32_ridge"], exact_ridge),
             "tf32_control_vs_float64": rel_err(r0["tf32_ridge"], exact_ridge),
             "l2_f32_vs_float64": rel_err(r0["f32"], exact),
             "l2_f32_vs_world1_f32": rel_err(r0["f32"], w1_f32), "builds": {}}
        for path, b in r0["builds"].items():
            same_ranks = all(np.array_equal(r["builds"][path]["indices"], b["indices"])
                             and np.array_equal(r["builds"][path]["weights"], b["weights"])
                             for r in ranks)
            cen = b["census"]
            w["builds"][path] = {
                "same_bits_every_rank": same_ranks, "folds": cen.get("fold", {}).get("calls"),
                "fold_bytes": cen.get("fold", {}).get("bytes"),
                "hull_gathers": cen.get("hull_gather", {}).get("calls"),
                "row_gathers": cen.get("row_gather", {}).get("calls"),
                "staged_bytes": cen.get("staged_bytes"),
                "build_s_per_rank": [r["builds"][path]["build_s"] for r in ranks]}
            if not same_ranks:
                errs.append(f"world {world} {path}: the ranks' coresets differ")
            if cen.get("fold", {}).get("calls") != 1 or cen.get("hull_gather", {}).get("calls") != 2:
                errs.append(f"world {world} {path}: collective census {cen} (want one fold, "
                            "one gather pair)")
        for r in ranks:
            census[f"world {world} gloo rank {r['rank']}"] = r["launches"]
        if "segmented" in r0:
            w["segmented"] = r0["segmented"]
            for strategy, s in r0["segmented"].items():
                if s["crashed_at"] != [MESH_SEG_CRASH] or not s["same_bits"]:
                    errs.append(f"world {world} segmented {strategy}: {s}")
        rec["worlds"][world] = w
        log(f"phase 11 world {world} (gloo, ranks on {ranks[0]['device']}): "
            + json.dumps({k: v for k, v in w.items() if k != "builds"}))
        for path, b in w["builds"].items():
            log(f"  world {world} {path}: " + json.dumps(b))
        if w["f64_vs_world1"] > MESH_F64_ATOL:
            errs.append(f"world {world}: f64-Gram scores {w['f64_vs_world1']} from world 1's")
        if w["f32_vs_float64"] > MESH_F32_RTOL:
            errs.append(f"world {world}: ridge-lss scores {w['f32_vs_float64']} from float64")
        if w["tf32_control_vs_float64"] <= MESH_F32_RTOL:
            errs.append(f"world {world}: MESH_F32_RTOL does not separate the TF32 Gram "
                        f"control: {w['tf32_control_vs_float64']}")
    for path, counts in census.items():
        need = ("bernstein", "sweep") if "one-pass" in path else (
            ("bernstein", "gram", "extremes") if "two-pass" in path
            else ("bernstein", "gram", "extremes", "sweep"))
        if any(counts.get(name, 0) <= 0 for name in need):
            errs.append(f"phase 11 {path}: the path's kernels did not all run {counts}")
    for path, counts in census.items():
        log(f"census {path}: {json.dumps(counts)}")
    if errs:
        fail("phase 11: " + "; ".join(errs))
    return census, rec


# ---------------------------------------------------------------- phase 12

TRAIN_MODELS = ("tinyllama-1.1b", "mamba2-370m")
TRAIN_STEPS = 30
TRAIN_LR = 1e-3                      # the phase's learning rate (launch/train.py's default: 3e-3)
TRAIN_ARGV = ["--coreset", "l2-hull", "--coreset-k", "512", "--batch", "8", "--seq", "64",
              "--lr", str(TRAIN_LR), "--log-every", "0"]
TRAIN_REDUCED = False                # a CPU rehearsal sets True (and the argv's --device)
TRAIN_PROFILE_STEPS = 3
EXAMPLE_CORPUS = (16, 128, 32)       # examples/train_lm_coreset.py: 16 batches of 128 × 32 tokens
EXAMPLE_K = 256
EXAMPLE_BATCH = 16
EXAMPLE_STEPS = 30
DRILL_STEPS, DRILL_EVERY, DRILL_CRASH = 10, 5, 7   # mamba2-370m: crash at step 7, resume from 5
SMALL_STEPS = 5
SMALL_REL = 1e-4                     # reduced f32 losses, card against CPU


def lm_kernel_modules() -> dict:
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssd import ops as ssd

    return {"flash_attention": fa, "ssd": ssd}


def reset_all_counts() -> None:
    reset_counts()
    for mod in lm_kernel_modules().values():
        mod.LAUNCHES = 0
        mod.PATH_LAUNCHES.update(dict.fromkeys(mod.PATH_LAUNCHES, 0))


def read_all_counts() -> dict:
    out = read_counts()
    out.update({k: mod.LAUNCHES for k, mod in lm_kernel_modules().items()})
    return out


def _lm_config(arch: str):
    from repro_torch.configs import get_config, get_reduced_config

    return get_reduced_config(arch) if TRAIN_REDUCED else get_config(arch)


def _train_argv(arch: str, steps: int) -> list:
    return TRAIN_ARGV + ["--arch", arch, "--steps", str(steps)] + (
        ["--reduced"] if TRAIN_REDUCED else [])


def _falling(losses) -> bool:
    import numpy as np

    losses = np.asarray(losses)
    return bool(np.isfinite(losses).all() and losses[-5:].mean() < losses[:5].mean())


def _train_driver(dev, arch: str, census: dict, errs: list) -> dict:
    """``launch/train.py``'s path for TRAIN_STEPS steps, then a profiler
    window over TRAIN_PROFILE_STEPS more steps of the same run."""
    import numpy as np
    import torch

    from repro_torch.launch import train

    reset_all_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run = train.run(train.parse_args(_train_argv(arch, TRAIN_STEPS)))
    _sync()
    run_s = time.perf_counter() - t0
    counts = read_all_counts()
    census[f"train {arch}"] = counts
    rec = dict(run.record)
    step_ms = np.asarray(rec.pop("step_s")) * 1e3
    rec.update({
        "run_s": run_s, "step_ms_first": float(step_ms[0]),
        "step_ms_median_5_30": float(np.median(step_ms[4:])),
        "tokens_per_s": rec["tokens_per_step"] / float(np.median(step_ms[4:])) * 1e3,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "params": sum(p.numel() for p in run.model.parameters()),
        "launches": counts,
    })
    if not _falling(rec["losses"]):
        errs.append(f"{arch}: losses not finite or not falling {rec['losses']}")
    if counts["ssd"] or counts["flash_attention"]:
        errs.append(f"{arch}: the LM kernels launched in training {counts}")
    if counts["gram"] <= 0 or counts["extremes"] <= 0:
        errs.append(f"{arch}: the coreset stage's kernels did not all run {counts}")
    state = run.state

    def steps():
        nonlocal state
        for i in range(TRAIN_PROFILE_STEPS):
            state, m = run.step_fn(state, run.batch_fn(TRAIN_STEPS + i))
        float(m["loss"])

    prof = profile_window(steps)
    rec["profile_3_steps"] = prof
    rec["device_busy_share"] = 1.0 - prof["device_idle_share"]
    # the profiler slows the host's issue, so the window's wall exceeds the
    # unprofiled steps': the device's time a step against those too
    rec["device_ms_per_step"] = prof["device_busy_ms"] / TRAIN_PROFILE_STEPS
    rec["device_share_of_step"] = rec["device_ms_per_step"] / rec["step_ms_median_5_30"]
    if read_all_counts()["ssd"] or read_all_counts()["flash_attention"]:
        errs.append(f"{arch}: the LM kernels launched in the profiled steps")
    del run, state
    torch.cuda.empty_cache()
    return rec


def _example_comparison(dev, census: dict, errs: list) -> dict:
    """``examples/train_lm_coreset.py`` at tinyllama-1.1b's full width: a
    2,048-example corpus featurized by the mean of the embeddings (D =
    d_model), k = 256 by l2-hull and by uniform, each trained from the same
    weights; the gap of the last-10 means, no gate on its sign."""
    import numpy as np
    import torch

    from repro_torch.data.pipeline import CoresetSelector, subset_loader
    from repro_torch.data.synthetic_lm import TokenStreamConfig, sample_batch
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, chain, clip_by_global_norm, cosine_warmup
    from repro_torch.train import init_train_state, make_train_step

    cfg = _lm_config("tinyllama-1.1b")
    n_batches, per, seq = EXAMPLE_CORPUS
    stream = TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=seq)
    corpus = [sample_batch(stream, per, s) for s in range(n_batches)]
    data = {k: np.concatenate([c[k] for c in corpus]) for k in ("tokens", "labels")}
    out = {"D": cfg.d_model, "n": int(data["tokens"].shape[0]), "k": EXAMPLE_K}
    for method in ("l2-hull", "uniform"):
        model = build_model(cfg, device=dev, seed=0, train=True)
        emb = model.emb["embed"].detach()

        def featurize(toks):
            return emb[torch.as_tensor(toks, device=emb.device).long()].mean(1)

        sel = CoresetSelector(featurize=featurize, method=method, device=dev)
        reset_all_counts()
        t0 = time.perf_counter()
        sub = sel.select(data["tokens"], k=EXAMPLE_K, generator=torch.Generator().manual_seed(1))
        _sync()
        sel_s = time.perf_counter() - t0
        census[f"example {method}"] = counts = read_all_counts()
        fn = subset_loader(data, sub, batch=EXAMPLE_BATCH)
        opt = chain(clip_by_global_norm(1.0), adamw(cosine_warmup(TRAIN_LR, 20, EXAMPLE_STEPS)))
        state, step = init_train_state(model.param_tree(), opt), make_train_step(model, opt)
        losses = []
        for i in range(EXAMPLE_STEPS):
            state, m = step(state, fn(i))
            losses.append(m["loss"])
        losses = [float(x) for x in losses]
        out[method] = {"select_s": sel_s, "subset": sub.size, "first_loss": losses[0],
                       "last10_mean": float(np.mean(losses[-10:])), "launches": counts}
        if sub.size != EXAMPLE_K or not np.isfinite(losses).all():
            errs.append(f"example {method}: {sub.size} examples, losses {losses}")
        if method == "l2-hull" and (counts["gram_large"] <= 0 or counts["extremes_wide"] <= 0):
            errs.append(f"example l2-hull at D = {cfg.d_model}: gram's large body or the "
                        f"wide-P route did not run {counts}")
        del model, state, emb, sel
        torch.cuda.empty_cache()
    out["gap_uniform_minus_l2hull"] = out["uniform"]["last10_mean"] - out["l2-hull"]["last10_mean"]
    return out


def _resume_drill(dev, scratch: str, census: dict, errs: list) -> dict:
    """mamba2-370m through the driver: a straight run of DRILL_STEPS steps;
    the same run with a checkpoint every DRILL_EVERY steps crashed at step
    DRILL_CRASH by the ft layer's injection, then resumed from its
    checkpoint: the resumed losses must equal the straight run's bits."""
    import torch

    from repro_torch.ft import FailureSimulator, InjectedFailure
    from repro_torch.ft.config import ft_overrides
    from repro_torch.launch import train

    argv = _train_argv("mamba2-370m", DRILL_STEPS) + ["--ckpt-every", str(DRILL_EVERY)]
    ckpt = os.path.join(scratch, "lm_drill")
    t0 = time.perf_counter()
    straight = train.main(argv)["losses"]
    straight_s = time.perf_counter() - t0
    crashed = False
    t0 = time.perf_counter()
    with ft_overrides(simulator=FailureSimulator().inject("fit", DRILL_CRASH)):
        try:
            train.main(argv + ["--ckpt-dir", ckpt])
        except InjectedFailure:
            crashed = True
    rec = train.main(argv + ["--ckpt-dir", ckpt, "--resume"])
    _sync()
    drill_s = time.perf_counter() - t0
    ckpt_bytes = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(ckpt) for f in fs)
    shutil.rmtree(ckpt, ignore_errors=True)
    same = rec["losses"] == straight[DRILL_EVERY:]
    out = {"crashed_at": DRILL_CRASH, "resumed_from": rec["start"], "same_bits": same,
           "straight_s": straight_s, "crash_and_resume_s": drill_s,
           "checkpoint_bytes": ckpt_bytes, "losses": rec["losses"]}
    if not crashed or rec["start"] != DRILL_EVERY or not same:
        errs.append(f"resume drill: crashed {crashed}, resumed from {rec['start']}, "
                    f"losses {rec['losses']} vs straight {straight[DRILL_EVERY:]}")
    torch.cuda.empty_cache()
    return out


def _small_agreement(dev, errs: list) -> dict:
    """The reduced configs in f32, SMALL_STEPS train steps on the card and on
    the CPU from the same weights and batches: losses within SMALL_REL."""
    import numpy as np

    from repro_torch.configs import get_reduced_config
    from repro_torch.data.synthetic_lm import TokenStreamConfig, sample_batch
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, chain, clip_by_global_norm, cosine_warmup
    from repro_torch.train import init_train_state, make_train_step

    out = {}
    for arch in TRAIN_MODELS:
        cfg = get_reduced_config(arch).replace(dtype="float32")
        stream = TokenStreamConfig(cfg.vocab_size, 64)
        losses = {}
        for where in ("cpu", str(dev)):
            model = build_model(cfg, device="cpu", seed=0, train=True).to(where)
            opt = chain(clip_by_global_norm(1.0), adamw(cosine_warmup(3e-3, 2, SMALL_STEPS)))
            state, step = init_train_state(model.param_tree(), opt), make_train_step(model, opt)
            ls = []
            for i in range(SMALL_STEPS):
                state, m = step(state, sample_batch(stream, 8, i))
                ls.append(float(m["loss"]))
            losses[where] = np.asarray(ls)
        rel = float(np.max(np.abs(losses[str(dev)] - losses["cpu"]) / np.abs(losses["cpu"])))
        out[arch] = {"max_rel_err": rel, "cpu": losses["cpu"].tolist()}
        log(f"small LM training {arch}: card vs CPU max rel err {rel:.3e}")
        if rel > SMALL_REL:
            errs.append(f"reduced {arch} training on the card disagrees with the CPU: {rel}")
    return out


def phase_lm_training(dev, scratch: str):
    """Phase 12: the LM training path (launch/train.py) at full width with
    the coreset stage, the example's comparison, the resume drill and the
    reduced configs card against CPU; returns the census and the record."""
    census, errs = {}, []
    rec = {"small": _small_agreement(dev, errs)}
    for arch in TRAIN_MODELS:
        rec[arch] = r = _train_driver(dev, arch, census, errs)
        log(f"train {arch}: step {r['step_ms_median_5_30']:.2f} ms (median of steps 5–30), "
            f"{r['tokens_per_s']:.1f} tokens/s, peak {r['peak_memory_gb']:.2f} GB, busy share "
            f"{r['device_busy_share']:.3f} (device {r['device_ms_per_step']:.2f} ms a step, "
            f"{r['device_share_of_step']:.3f} of an unprofiled one), select_s "
            f"{r['select_s']:.3f}, losses "
            f"{r['losses'][0]:.4f} → {r['losses'][-1]:.4f}, stage launches "
            f"{json.dumps(r['launches'])}")
    rec["example"] = _example_comparison(dev, census, errs)
    log("example (l2-hull vs uniform, k = 256 of 2,048): " + json.dumps(rec["example"]))
    rec["drill"] = _resume_drill(dev, scratch, census, errs)
    log("resume drill mamba2-370m: " + json.dumps(
        {k: v for k, v in rec["drill"].items() if k != "losses"}))
    if errs:
        fail("phase 12: " + "; ".join(errs))
    return census, rec


# ---------------------------------------------------------------- phase 13

AUDIT_KERNELS = ("bernstein", "gram", "extremes", "sweep")
AUDIT_PATHS = {"gram_cluster": "gram/cluster", "gram_tiled": "gram/tiled",
               "gram_large": "gram/large", "extremes_wide": "extremes/wide",
               "sweep_wide": "sweep/wide"}


def _audit_launches(rep: dict) -> dict:
    """One audited call's launches in ``read_counts``' names."""
    m = rep["metrics"]
    out = dict(m.get("kernels", {}))
    paths = m.get("kernel_paths", {})
    out.update({k: paths[p] for k, p in AUDIT_PATHS.items() if paths.get(p)})
    return out


def phase_audit(dev):
    """Phase 13: the invariant auditor's programs on the card against their
    budgets and against the CPU audit, the violations caught on the card,
    the dry run's records; returns the launch census and the record."""
    from repro_torch.analysis import all_programs, audit_program
    from repro_torch.analysis.checks import PORTABLE_METRICS
    from repro_torch.analysis.programs import PHASE3, WIDTH_PROGRAMS, make_programs
    from repro_torch.analysis.violations import VIOLATIONS
    from repro_torch.launch import dryrun_coreset

    census, errs = {}, []
    rec = {"programs": {}, "phase3_width": {}, "violations": {}}
    for spec in all_programs():
        cpu = audit_program(spec, device="cpu")
        card = audit_program(spec, device=dev)
        for where, rep in (("cpu", cpu), (str(dev), card)):
            if not rep["ok"]:
                errs.append(f"{spec.name} on {where}: " + "; ".join(rep["failures"])[:600])
        diff = {k: (cpu["metrics"].get(k), card["metrics"].get(k)) for k in PORTABLE_METRICS
                if cpu["metrics"].get(k) != card["metrics"].get(k)}
        if diff:
            errs.append(f"{spec.name}: the card's census differs from the CPU's: {diff}")
        census[spec.name] = _audit_launches(card)
        rec["programs"][spec.name] = {"cpu": cpu["metrics"], "card": card["metrics"]}
        m = card["metrics"]
        log(f"audit {spec.name}: ok cpu {cpu['ok']} card {card['ok']}; collectives "
            f"{ {k: v for k, v in m.get('collectives', {}).items() if v} } "
            f"({m.get('collective_bytes')} B), host reads {m.get('host_reads')}, launches "
            f"{json.dumps(census[spec.name])}, device kernels {m.get('device_kernels')}")
    for spec in make_programs(PHASE3):
        if spec.name not in WIDTH_PROGRAMS:
            continue
        rep = audit_program(spec, device=dev)
        if not rep["ok"]:
            errs.append(f"{spec.name} at phase 3's width: " + "; ".join(rep["failures"])[:600])
        key = f"{spec.name} (phase 3 width)"
        census[key] = _audit_launches(rep)
        rec["phase3_width"][spec.name] = rep["metrics"]
        m = rep["metrics"]
        log(f"audit {key}: ok {rep['ok']}; host reads {m.get('host_reads')}, collectives "
            f"{ {k: v for k, v in m.get('collectives', {}).items() if v} } "
            f"({m.get('collective_bytes')} B), launches {json.dumps(census[key])}, device "
            f"kernels {m.get('device_kernels')}")
    for name, spec in VIOLATIONS.items():
        rep = audit_program(spec, device=dev)
        rec["violations"][name] = rep["failures"]
        log(f"violation {name} on the card: {'caught' if not rep['ok'] else 'MISSED'}"
            + (f" ({rep['failures'][0][:160]})" if rep["failures"] else ""))
        if rep["ok"]:
            errs.append(f"violation {name} audited clean on the card")
    for k in AUDIT_KERNELS:
        if not any(c.get(k) for c in census.values()):
            errs.append(f"kernel {k} was not launched inside the audited programs")
    rec["dryrun"] = dryrun_coreset.main(["--out", os.path.join(ROOT, "results", "dryrun")])
    for r in rec["dryrun"]:
        log(f"dry run {r['mesh']} {r['variant']}: {r['flops']:.6g} FLOP, {r['bytes']:.6g} B, "
            f"collectives {r['collectives']} ({r['collective_bytes']:.6g} B); compute "
            f"{r['compute_s']:.6g} s, memory {r['memory_s']:.6g} s, collective "
            f"{r['collective_s']:.6g} s, dominant {r['dominant']}")
    if errs:
        fail("phase 13: " + "; ".join(errs))
    return census, rec


def main() -> None:
    t_script = time.perf_counter()
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
    mctm_kernels, wide = phase_kernels(dev)
    kernels_at_d16 = phase_kernels_d16(dev)
    wide_row, wide["extremes_wide"] = phase_wide_extremes(dev)
    lm_rows = phase_lm_kernels(dev)
    p9_rows, wide["wide_d"] = phase_kernels_wide_d(dev)
    kernels = mctm_kernels + [wide_row] + p9_rows + lm_rows
    phase_small_agreement(dev)
    wide["scoring_j10"] = phase_wide_scoring(dev)
    launches, two_pass_params = phase_path(dev)
    launches["gram_tiled"] = wide["scoring_j10"]["gram_tiled_launches"]
    launches["extremes_wide"] = wide["extremes_wide"]["hull_api_d70"]["launches"]["extremes_wide"]
    phase_lm_small_agreement(dev)
    serve_launches, serve = phase_serve(dev)
    launches.update(serve_launches)
    t0 = time.perf_counter()
    core_census, core = phase_core(dev, two_pass_params, kernels_at_d16)
    log(f"phase 6 took {time.perf_counter() - t0:.1f}s")
    scratch = os.path.join(ROOT, "build", "chip_smoke_ft")
    shutil.rmtree(scratch, ignore_errors=True)
    t0 = time.perf_counter()
    ft_census, ft_rec = phase_fault_tolerance(dev, scratch)
    log(f"phase 7 took {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    stream_census, stream_rec = phase_streaming(dev, scratch)
    log(f"phase 8 took {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    p9_census, p9_rec = phase_pipeline(dev, scratch)
    log(f"phase 9 took {time.perf_counter() - t0:.1f}s")
    shutil.rmtree(scratch, ignore_errors=True)
    t0 = time.perf_counter()
    p10_census, p10_rec = phase_serving(dev)
    log(f"phase 10 took {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    mesh_scratch = os.path.join(ROOT, "build", "chip_smoke_mesh")
    shutil.rmtree(mesh_scratch, ignore_errors=True)
    p11_census, p11_rec = phase_mesh(dev, mesh_scratch)
    shutil.rmtree(mesh_scratch, ignore_errors=True)
    log(f"phase 11 took {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    lm_scratch = os.path.join(ROOT, "build", "chip_smoke_lm")
    shutil.rmtree(lm_scratch, ignore_errors=True)
    p12_census, p12_rec = phase_lm_training(dev, lm_scratch)
    shutil.rmtree(lm_scratch, ignore_errors=True)
    log(f"phase 12 took {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    p13_census, p13_rec = phase_audit(dev)
    log(f"phase 13 took {time.perf_counter() - t0:.1f}s ({card})")
    launches["gram_large"] = p9_census["select D=2048 two-pass"]["gram_large"]
    launches["sweep_wide"] = p9_census["select D=2048 one-pass"]["sweep_wide"]
    for row in kernels:
        row["launches"] = launches[row["name"]]
        if row["launches"] <= 0:
            fail(f"kernel {row['name']} was not launched on its path")
        name = "gram_cluster" if row["name"] == "gram" else row["name"]
        for key, cen in (("launches_phase6", core_census), ("launches_phase7", ft_census),
                         ("launches_phase8", stream_census), ("launches_phase9", p9_census),
                         ("launches_phase10", p10_census), ("launches_phase11", p11_census),
                         ("launches_phase12", p12_census),
                         ("launches_phase13", p13_census)):
            row[key] = {path: counts[name] for path, counts in cen.items() if counts.get(name)}
    out_dir = os.path.join(ROOT, "results")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "kernels": kernels, "wide": wide, "serve": serve, "core": core,
                   "core_census": core_census, "fault_tolerance": ft_rec,
                   "ft_census": ft_census, "streaming": stream_rec,
                   "stream_census": stream_census, "pipeline": p9_rec,
                   "pipeline_census": p9_census, "serving": p10_rec,
                   "serving_census": p10_census, "mesh": p11_rec, "mesh_census": p11_census,
                   "lm_training": p12_rec, "lm_training_census": p12_census,
                   "audit": p13_rec, "audit_census": p13_census},
                  f, indent=1, default=float)
    log(f"the script took {time.perf_counter() - t_script:.1f}s ({card})")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
