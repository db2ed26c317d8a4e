"""Times the launch plans of three CUDA kernel bodies of the port on one
card: the extremes kernel's wide body at m = 1 (the greedy hull walk) with
blocks of 1–8 row tiles, and gram's large body at D = 2,048 over several
row splits, each forced through the wrapper in place of its plan; then the
Gram of a 2,049-column X (padded by the wrapper) beside ``torch.mm``; then
the sweep past D = 160 (the partition and the sketch tiles) at D 2,048 ×
sketch 16,384 and D 300 × sketch 4,096 over the buckets a range (4, 8, 16)
and the threads a tile (64, 128, 256: slabs of 256–1,024 columns), each in
turns with ``index_add_``. Every forced call is held to the plain version
first (the extremes and the sweep to the bit, gram within 1e-5·max|G| of
float64). Device times from ``torch.profiler`` (``chip_smoke.device_ms``).

    python3 scripts/torch_plan_timings.py [--out results/plan_timings.json]
                                          [--only extremes,gram,sweep]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "results", "plan_timings.json"))
    ap.add_argument("--only", default="extremes,gram,sweep",
                    help="comma-separated sections to time")
    args = ap.parse_args()
    only = set(args.only.split(","))
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    import chip_smoke as cs
    from repro_torch.kernels.extremes import ops as ext
    from repro_torch.kernels.extremes.ref import directional_extremes_ref
    from repro_torch.kernels.gram import ops as gram

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator().manual_seed(5)
    out: dict = {"card": card, "sms": sms}

    # ---- the wide extremes body at m = 1: t row tiles a block
    plan_of, m1 = ext.wide_launch_plan, {}
    for d in ((70, 1024) if "extremes" in only else ()):
        rows = 16_384
        P = torch.randn((rows, d), generator=gen).to(dev)
        D = torch.randn((1, d), generator=gen).to(dev)
        ref = directional_extremes_ref(P, D)
        trows = ext.WIDE_TILES[1][1]
        for t in (1, 2, 4, 8):
            plan = ext.WidePlan(1, t * trows, -(-rows // (t * trows)))
            ext.wide_launch_plan = lambda r, m, s, plan=plan: plan
            try:
                fn = lambda: ext.directional_extremes(P, D)  # noqa: E731
                bits = all(cs.same_bits(g, r) for g, r in zip(fn(), ref))
                w = cs.clean_window(fn, 50)
            finally:
                ext.wide_launch_plan = plan_of
            m1[f"d{d}_t{t}"] = {"plan": plan._asdict(), "bits": bits,
                                "device_ms": w["device_busy_ms"] / 50,
                                "kernels_ms": {k: v / 50 for k, v in w["top_kernels_ms"].items()}}
            print(json.dumps({f"d{d}_t{t}": m1[f"d{d}_t{t}"]}), flush=True)
        m1[f"d{d}_plan"] = plan_of(rows, 1, sms)._asdict()
    out["extremes_m1"] = m1
    ok = all(v["bits"] for k, v in m1.items() if "bits" in v)
    if "gram" in only:
        ok = _gram(cs, gram, dev, gen, out) and ok
    if "sweep" in only:
        ok = _sweep(cs, dev, gen, sms, out) and ok
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=1)
    if not ok:
        sys.exit("a forced plan disagreed with its plain version")
    print(json.dumps({"ok": True}))


def _gram(cs, gram, dev, gen, out) -> bool:
    import torch

    # ---- gram's large body at D 2,048: the splits, in turns (forward, back)
    n, Dg = 16_384, 2048
    X = torch.randn((n, Dg), generator=gen).to(dev)
    G64 = X.double().T @ X.double()
    large_of = gram.large_plan
    tiles, picked = large_of(n, Dg)
    fns, sp = {}, {"plan": picked}
    for s in (1, 3, 6, 9, 12, 16, 24):
        def fn(s=s):
            gram.large_plan = lambda n_, D_: (tiles, s)
            try:
                return gram.gram_matrix(X)
            finally:
                gram.large_plan = large_of
        fns[s] = fn
        G = fn()
        sp[f"s{s}"] = {"rel_err": float((G.double() - G64).abs().max() / G64.abs().max())}
    for order in (list(fns), list(fns)[::-1]):
        for s in order:
            sp[f"s{s}"].setdefault("turns_device_ms", []).append(cs.device_ms(fns[s], 10))
    for s in fns:
        sp[f"s{s}"]["device_ms"] = sum(sp[f"s{s}"]["turns_device_ms"]) / 2
    print(json.dumps({"gram_splits": sp}), flush=True)
    out["gram_splits_D2048"] = sp

    # ---- a 2,049-column Gram (padded to 2,052 by the wrapper) and torch.mm
    X9 = torch.randn((n, 2049), generator=gen).to(dev)
    G9, G9r = gram.gram_matrix(X9), X9.double().T @ X9.double()
    t = cs.in_turns(lambda: gram.gram_matrix(X9), lambda: torch.mm(X9.T, X9))
    t["rel_err"] = float((G9.double() - G9r).abs().max() / G9r.abs().max())
    print(json.dumps({"gram_D2049": t}), flush=True)
    out["gram_D2049"] = t
    return all(v["rel_err"] <= 1e-5 for k, v in sp.items() if k != "plan") and t["rel_err"] <= 1e-5


def _sweep(cs, dev, gen, sms, out) -> bool:
    """The sweep past D = 160 over the buckets a range × the threads a tile
    at most (``WIDE_BUCKETS``, ``WIDE_TILE_THREADS``), forced through the
    wrapper, each variant first held to the plain version's SX' and z bits
    (on the CPU), then timed in turns with index_add_ (variant, library,
    library, variant) by device ms."""
    import torch

    from repro_torch.kernels.sweep import ops as sweep
    from repro_torch.kernels.sweep.ref import fused_sweep_ref

    plan_of = (sweep.WIDE_BUCKETS, sweep.WIDE_TILE_THREADS)  # restored after each call
    ok, res = True, {}
    for c, D, sk in ((16_384, 2048, 16_384), (16_384, 300, 4096)):
        X = torch.rand((c, D), generator=gen)
        sw = torch.rand(c, generator=gen)
        rows = torch.randint(0, sk, (c,), generator=gen, dtype=torch.int32)
        signs = torch.randint(0, 2, (c,), generator=gen).float() * 2 - 1
        SX = torch.randn((sk, D), generator=gen)
        plain = fused_sweep_ref(SX, X, None, sw, rows, signs)[:2]
        Xc, swc, rowsc, signsc, SXc = (t.to(dev) for t in (X, sw, rows, signs, SX))

        def library():
            return SXc.clone().index_add_(0, rowsc.long(), Xc * signsc[:, None])

        shape = f"D{D}_sk{sk}"
        res[shape] = {"plan": sweep.launch_plan(c, D, 1, 1, sk, 0, sms)}
        for bk in (4, 8, 16):
            for threads in (64, 128, 256):
                def fn(bk=bk, threads=threads):
                    sweep.WIDE_BUCKETS, sweep.WIDE_TILE_THREADS = (bk,), threads
                    try:
                        return sweep.fused_sweep_update(SXc, Xc, None, swc, rowsc, signsc)
                    finally:
                        sweep.WIDE_BUCKETS, sweep.WIDE_TILE_THREADS = plan_of
                got = fn()
                bits = all(cs.same_bits(g, e) for g, e in zip(got[:2], plain))
                ok = ok and bits
                t = cs.in_turns(fn, library)
                v = {"bits": bits, "device_ms": t["device_ms"],
                     "library_device_ms": t["library_device_ms"], "ratio": t["device_ratio"],
                     "turns_device_ms": t["turns_device_ms"], "ms": t["ms"]}
                res[shape][f"bk{bk}_t{threads}"] = v
                print(json.dumps({shape: {f"bk{bk}_t{threads}": v}}), flush=True)
        res[shape]["bound_ms"] = cs.bound_ms(4 * (2 * c * D + 2 * sk * D + 3 * c), 3 * c * D)[0]
    out["sweep_wide"] = res
    return ok


if __name__ == "__main__":
    main()
