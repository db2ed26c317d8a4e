"""Times flash_attention's bodies at the served prefill shapes on one card,
each in turns with what it is compared with (``chip_smoke.in_turns``: A, B,
B, A, by CUDA events and by device time), after checking it against its
plain version (atol 3e-2 and ``bf16_error_bound``):

- bf16 d = 96 at phi-3-vision's (1, 1,280, 32, 96): the wgmma body against
  SDPA, and against the f32-FMA body that took this width before;
- d = 256 at recurrentgemma-2b's (1, 1,024, 10, 256) and gemma-2b's (1,
  1,024, 8, 256), one KV head: the split grid against SDPA, and against the
  unsplit grid (one CTA a q tile), with two calls' bits compared, and the
  device time at other caps (key tiles a CTA) beside the plan's;
- the other served shapes: d = 64 at tinyllama's (1, 1,024, 32, 64) KV 4,
  d = 128 at qwen2-moe's (16, KV 16; also its 768-token prompt, whose 96
  q tiles split) and arctic's (56, KV 8), and d = 64 non-causal at
  whisper-medium's encoder (4, 1,500, 16, 64); any shape that splits also
  against the unsplit grid.

    python3 scripts/torch_flash_probe.py [ROOT] [TAG] [--quick] [--anatomy]

ROOT is the checkout to import (default: this one; a checkout without the
split grid times the d = 256 rows against SDPA only). ``--quick`` checks the
new shapes and times nothing. ``--anatomy`` adds the d = 256 body's device
time unsplit at (1, S, H, KV, 256), causal: one head at S = 256 … 1,024
(its heaviest CTA walks 4 … 16 key tiles nearly alone: the per-tile time
and the fixed cost) and 1,024 positions at 1–10 heads on one KV head and on
as many (what many CTAs at once cost). Card only; prints one JSON line a
shape.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys


def main() -> None:
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    root = os.path.abspath(args[0] if args else os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    tag = args[1] if len(args) > 1 else os.path.basename(root)
    quick = "--quick" in sys.argv
    sys.path[:0] = [os.path.join(root, "src"), root]
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    import chip_smoke as cs
    from repro_torch.kernels import _lib
    from repro_torch.kernels.flash_attention import ops, ref

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    _lib.lib()
    print(json.dumps({"root": root, "tag": tag, "card": smi}), flush=True)
    for line in cs.ptxas_report(_lib.BUILD_LOG):
        if "flash" in line:
            print(line, flush=True)
    g = torch.Generator().manual_seed(28)
    shapes = {"d96": (1, 1280, 32, 32, 96, True), "d256": (1, 1024, 10, 1, 256, True),
              "d256_gemma": (1, 1024, 8, 1, 256, True)}
    if not quick:
        shapes.update({"d64": (1, 1024, 32, 4, 64, True), "d128": (1, 1024, 16, 16, 128, True),
                       "d128_768": (1, 768, 16, 16, 128, True),
                       "d128_arctic": (1, 1024, 56, 8, 128, True),
                       "enc": (4, 1500, 16, 16, 64, False)})
    for key, (B, S, H, KV, d, causal) in shapes.items():
        q, k, v = (torch.randn(B, S, h, d, generator=g).to(dev, torch.bfloat16)
                   for h in (H, KV, KV))
        out = ops.flash_attention(q, k, v, causal=causal)
        o, bound = ref.bf16_error_bound(q, k, v, causal=causal)
        err = float((out.float() - o).abs().max())
        rec = {"tag": tag, "shape": key, "dims": [B, S, H, KV, d], "causal": causal,
               "body": ops.kernel_path(q), "max_abs_err": err,
               "bound_use": float(((out.float() - o).abs() / bound).max()),
               "same_bits": bool(torch.equal(out, ops.flash_attention(q, k, v, causal=causal)))}
        del o, bound
        plan = getattr(ops, "split_plan", None)
        if plan is not None and rec["body"] == "wgmma":
            rec["plan"] = plan(S, B * H, d, causal, _lib.sm_count(0))
        if not quick:

            def kernel(q=q, k=k, v=v, causal=causal):
                return ops.flash_attention(q, k, v, causal=causal)

            def sdpa(q=q, k=k, v=v, causal=causal):
                return torch.nn.functional.scaled_dot_product_attention(
                    *(t.transpose(1, 2) for t in (q, k, v)), is_causal=causal, enable_gqa=True)

            t = cs.in_turns(kernel, sdpa)
            rec["vs_sdpa"] = {n: t[n] for n in ("device_ms", "library_device_ms", "device_ratio",
                                                "ms", "library_ms", "turns_device_ms")}
            if rec.get("plan", (0, 0))[1]:  # the split grid's kernels
                w = cs.clean_window(kernel, 10)
                rec["kernels_ms"] = {n: ms / 10 for n, ms in w["top_kernels_ms"].items()}
            other = None
            top = max(ref.key_tiles(S, 64 if d > 128 else 128, causal, 128))
            if not hasattr(ops, "_launch"):  # a checkout before the split grid
                pass
            elif key == "d96":  # the f32-FMA body this width took before
                other = lambda q=q, k=k, v=v: ops._launch(q, k, v, True, "simt")[0]  # noqa: E731
            elif rec["plan"][1]:  # a split grid: the unsplit one, and at d = 256 other caps
                other = lambda q=q, k=k, v=v, c=top, causal=causal: ops._launch(  # noqa: E731
                    q, k, v, causal, "wgmma", cap=c)[0]
            if d == 256 and hasattr(ops, "_launch"):
                rec["caps_device_ms"] = {
                    c: cs.device_ms(lambda q=q, k=k, v=v, c=c: ops._launch(
                        q, k, v, causal, "wgmma", cap=c)[0])
                    for c in (4, 6, 8, 10, 12, top) if -(-top // c) <= ops._C["kSplitMaxParts"]}
            if other is not None:
                rec["other_max_abs_err"] = float((other().float() - out.float()).abs().max())
                t = cs.in_turns(kernel, other)
                rec["vs_other"] = {n: t[n] for n in ("device_ms", "library_device_ms",
                                                     "device_ratio", "turns_device_ms")}
        print(json.dumps(rec), flush=True)
    if "--anatomy" in sys.argv and hasattr(ops, "_launch"):
        rows = {}
        for S, H, KV in ((256, 1, 1), (512, 1, 1), (768, 1, 1), (1024, 1, 1), (1024, 2, 1),
                         (1024, 5, 1), (1024, 10, 1), (1024, 10, 10), (1024, 20, 1)):
            q, k, v = (torch.randn(1, S, h, 256, generator=g).to(dev, torch.bfloat16)
                       for h in (H, KV, KV))
            top = max(ref.key_tiles(S, 64, True, ops.ROWS))
            rows[f"S{S}_H{H}_KV{KV}"] = cs.device_ms(
                lambda q=q, k=k, v=v, c=top: ops._launch(q, k, v, True, "wgmma", cap=c)[0])
        print(json.dumps({"tag": tag, "anatomy_unsplit_device_ms": rows}), flush=True)


if __name__ == "__main__":
    main()
