"""Times the port's sweep at D 2,048 × sketch 16,384 × 16,384 points (the
one-pass selector's chunk, no P rows) in any checkout of this repository,
so that two designs can be compared on one card: run it once per checkout,
in turns (A, B, B, A). It prints one JSON line: the call's device ms in
turns with ``index_add_`` (``chip_smoke.in_turns``), its kernels' device ms
(``chip_smoke.clean_window``), and the call without z (``want_z=False``).
With ``--probes`` it adds a plain copy of SX → SX' and X → z (the bytes
the call must move, at the rate the card reaches) and, in a checkout whose
sketch CTAs take every D (before the partition and tiles), the call with
the plan's buckets a sketch CTA forced to 32 and 128.

    python3 scripts/torch_sweep_probe.py [ROOT] [TAG] [--probes]

ROOT is the checkout to import (default: this one); card only.
"""
from __future__ import annotations

import json
import os
import sys


def main() -> None:
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    root = os.path.abspath(args[0] if args else os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    tag = args[1] if len(args) > 1 else os.path.basename(root)
    sys.path[:0] = [os.path.join(root, "src"), root]
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    import chip_smoke as cs
    from repro_torch.kernels.sweep import ops

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(90)
    c, D, sk = 16_384, 2048, 16_384
    X = torch.rand(c, D, generator=g).to(dev)
    sw = torch.ones(c, device=dev)
    rows = torch.randint(0, sk, (c,), generator=g).int().to(dev)
    signs = (torch.randint(0, 2, (c,), generator=g) * 2 - 1).float().to(dev)
    SX0 = torch.zeros(sk, D, device=dev)
    out = {"root": root, "tag": tag}

    def full():
        return ops.fused_sweep_update(SX0, X, None, sw, rows, signs)

    def library():
        return SX0.clone().index_add_(0, rows.long(), X * signs[:, None])

    t = cs.in_turns(full, library)
    out["full"] = {k: t[k] for k in ("device_ms", "library_device_ms", "ms", "library_ms",
                                     "turns_device_ms")}
    w = cs.clean_window(full, 10)
    out["full_kernels_ms"] = {k: v / 10 for k, v in w["top_kernels_ms"].items()}
    out["sketch_only_device_ms"] = cs.device_ms(
        lambda: ops.fused_sweep_update(SX0, X, None, sw, rows, signs, want_z=False), 10)
    if "--probes" in sys.argv:
        plan_of = ops.launch_plan

        def forced(bk):
            def fn():
                ops.launch_plan = lambda *a: {**plan_of(*a), "bk": bk, "ns": -(-sk // bk)}
                try:
                    return ops.fused_sweep_update(SX0, X, None, sw, rows, signs)
                finally:
                    ops.launch_plan = plan_of
            return fn

        if "tile_threads" not in plan_of(c, D, 1, 1, sk, 0, 132):
            for bk in (32, 128):
                out[f"bk{bk}_device_ms"] = cs.device_ms(forced(bk), 10)
        SXo, z = torch.empty_like(SX0), torch.empty_like(X)
        out["copy_floor_device_ms"] = cs.device_ms(lambda: (SXo.copy_(SX0), z.copy_(X)), 10)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
