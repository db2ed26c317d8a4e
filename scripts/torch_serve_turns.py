"""Times the serving path of two checkouts of the port in turns on one card:
each full-width model serves ``chip_smoke.py`` phase 4's eight requests
(prompts of 256, 512, 768 and 1,024 tokens, twice; 32 new tokens each)
through ``ServeEngine`` with 4 slots, after one warm-up request, REPS times
in one process a turn. A turn reports, per model, the mean prefill ms by
prompt length and the median decode ms a tick over its REPS drains.

    python3 scripts/torch_serve_turns.py ROOT_A ROOT_B [--order ABBA]
        [--models tinyllama_1b,mamba2_370m] [--reps 3] [--out FILE]
    python3 scripts/torch_serve_turns.py --points [--models ...]

ROOT_A and ROOT_B are checkouts (their ``src/`` is imported; each builds its
own kernels under its ``build/``). Every turn is a fresh process on the
card, so the turns A, B, B, A share the host's state as evenly as one call
allows. Prints one JSON line a turn and, last, the medians by checkout;
``--out`` also writes them. Card only.

``--points`` counts, on the CPU, the calls the model makes to the named
redistribution points of ``distributed/sharding.py`` while it serves the
same eight requests (each model's reduced widths at its published depth):
calls a prefill and a decode tick, and the host time of one call on a
plain tensor outside ``dtensor_run()`` (the median of 20 timings of 10^5
calls), so their product bounds what the points add to a tick's host work.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

SLOTS, MAX_LEN, NEW = 4, 2048, 32
PROMPTS = (256, 512, 768, 1024) * 2


def _drain(model, prompts, dev, new: int):
    """A fresh engine serving ``prompts`` (``new`` tokens each) to the end:
    (engine, finished requests)."""
    import torch

    from repro_torch.serve import GenerationConfig, Request, ServeEngine

    eng = ServeEngine(model, n_slots=SLOTS, max_len=MAX_LEN, device=dev, keep_logits=True)
    eng.cache["pos"] = torch.zeros(SLOTS, dtype=torch.int32, device=dev)
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=p, gen=GenerationConfig(max_new_tokens=new)))
    done = eng.run_until_drained()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return eng, done


def _prompts(cfg) -> list:
    import numpy as np

    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in PROMPTS]


def serve_turn(models: list[str], reps: int) -> dict:
    """One turn in this process: {model: {prefill_ms: {len: ms}, decode_ms_per_tick}}."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    dev = torch.device("cuda", 0)
    out = {}
    for name in models:
        cfg = get_config(name)
        model = build_model(cfg, device=dev, seed=0)
        prompts = _prompts(cfg)
        _drain(model, prompts[:1], dev, 2)  # first calls: kernels, cuBLAS handles, pools
        pre, ticks = [], []
        for _ in range(reps):
            eng, done = _drain(model, prompts, dev, NEW)
            if len(done) != len(prompts) or any(len(r.output) != NEW for r in done):
                raise RuntimeError(f"{name}: {len(done)} of {len(prompts)} requests finished")
            pre.append(np.asarray(eng.prefill_seconds) * 1e3)
            ticks += list(np.asarray(eng.tick_seconds) * 1e3)
        pre = np.stack(pre)
        out[name] = {
            "prefill_ms": {str(n): float(pre[:, i::4].mean()) for i, n in enumerate(PROMPTS[:4])},
            "decode_ms_per_tick": float(np.median(ticks)),
        }
        del model
        torch.cuda.empty_cache()
    return out


def point_census(models: list[str]) -> dict:
    """{model: calls a prefill and a decode tick to the named points} on
    the CPU, and the host ns of one gated call (module doc)."""
    import time

    import numpy as np
    import torch

    from repro_torch.configs import get_config, get_reduced_config
    from repro_torch.distributed import sharding
    from repro_torch.models import encdec, layers, rglru, ssm, transformer

    calls = {"n": 0}
    for mod in (layers, transformer, ssm, encdec, rglru):
        for name in sharding.__all__:
            fn = getattr(mod, name, None)
            if callable(fn) and fn is getattr(sharding, name) and not isinstance(fn, type):
                def counted(*a, _fn=fn, **k):
                    calls["n"] += 1
                    return _fn(*a, **k)
                setattr(mod, name, counted)
    out = {}
    dev = torch.device("cpu")
    for name in models:
        cfg = get_reduced_config(name).replace(n_layers=get_config(name).n_layers)
        model = transformer.build_model(cfg, device=dev, seed=0)
        prompts = _prompts(cfg)
        calls["n"] = 0
        eng, done = _drain(model, prompts, dev, NEW)
        total = calls["n"]
        calls["n"] = 0
        cache = model.init_cache(1, MAX_LEN)
        model.prefill({"tokens": prompts[3][None, :]}, cache)
        per_prefill = calls["n"]
        out[name] = {"n_layers": cfg.n_layers, "calls_a_prefill": per_prefill,
                     "ticks": eng.ticks,
                     "calls_a_tick": (total - per_prefill * len(prompts)) / eng.ticks}
    x = torch.zeros(4)
    times = []
    for _ in range(20):
        t0 = time.perf_counter()
        for _ in range(100_000):
            sharding.reduce_partial("residual", x)
        times.append((time.perf_counter() - t0) / 100_000 * 1e9)
    out["ns_a_call"] = float(np.median(times))
    return out


def main() -> None:
    args = sys.argv[1:]
    if args and args[0] == "--turn":
        print("TURN " + json.dumps(serve_turn(args[1].split(","), int(args[2]))), flush=True)
        return
    if args and args[0] == "--points":
        models = (args[args.index("--models") + 1] if "--models" in args
                  else "tinyllama_1b,mamba2_370m")
        print(json.dumps(point_census(models.split(","))), flush=True)
        return
    opts = {"--order": "ABBA", "--models": "tinyllama_1b,mamba2_370m", "--reps": "3",
            "--out": None}
    roots = []
    it = iter(args)
    for a in it:
        if a in opts:
            opts[a] = next(it)
        else:
            roots.append(os.path.abspath(a))
    if len(roots) != 2:
        raise SystemExit(__doc__)
    models = opts["--models"].split(",")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print("card: " + card, flush=True)
    turns = []
    for tag in opts["--order"]:
        root = roots["AB".index(tag)]
        env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--turn",
                               ",".join(models), opts["--reps"]], env=env, cwd=root,
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"turn {tag} ({root}) failed:\n{proc.stderr[-3000:]}")
        line = next(x for x in proc.stdout.splitlines() if x.startswith("TURN "))
        rec = {"tag": tag, "root": root, **json.loads(line[5:])}
        turns.append(rec)
        print(json.dumps(rec), flush=True)
    summary = {}
    for tag in "AB":
        mine = [t for t in turns if t["tag"] == tag]
        summary[tag] = {m: {
            "decode_ms_per_tick": sorted(t[m]["decode_ms_per_tick"] for t in mine),
            "prefill_1024_ms": sorted(t[m]["prefill_ms"]["1024"] for t in mine)}
            for m in models}
    print(json.dumps({"card": card, "summary": summary}), flush=True)
    if opts["--out"]:
        with open(opts["--out"], "w") as f:
            json.dump({"card": card, "turns": turns, "summary": summary}, f, indent=1)


if __name__ == "__main__":
    main()
