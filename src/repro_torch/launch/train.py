"""Training driver for the LM configs: the port of ``repro.launch.train``.

``python -m repro_torch.launch.train --arch tinyllama-1.1b --steps 200 --reduced \\
      --coreset l2-hull --coreset-k 512 [--device cpu]``

Wires together: model zoo → data (the synthetic token stream, with the
coreset selection stage in front) → train step → checkpoint manager → the
step loop. ``--device`` defaults to the CUDA device, ``--arch`` to
olmo-1b (the reference's). The model trains float32 masters with
activations in the config's dtype, through the plain PyTorch attention and
SSD scan (the reference trains through its jnp twins; no kernel of the
reference lies on this path); the coreset stage scores the corpus on the
card's kernels. A vision config's batches carry stub patch embeddings and
an encdec config's stub frames (``augment``); the model moves them to the
device with the tokens. ``--ckpt-dir`` saves the train
state every ``--ckpt-every`` steps and at the end; ``--resume`` restarts
from the latest save, and a resumed run gives the straight run's losses.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.data.synthetic_lm import TokenStreamConfig, sample_batch, sample_modality_stub
from repro_torch.device import resolve_device
from repro_torch.launch.stages import coreset_subset_loader
from repro_torch.models import build_model
from repro_torch.optim import adamw, chain, clip_by_global_norm, cosine_warmup
from repro_torch.train import init_train_state, make_train_step, restore_train_state, train_loop

SELECTION_SEED = 7  # the selection's draws (the reference's PRNGKey(7))


def augment(cfg, batch: dict, step: int, seq_len: int) -> dict:
    """``batch`` with the modality stubs a config's model reads (the
    reference's ``augment``): a vision config's "patch_embeds" (B,
    n_modality_positions, d), an encdec config's "frames" (B, seq_len, d),
    both ``sample_modality_stub(..., step)``."""
    if cfg.modality == "vision":
        batch["patch_embeds"] = sample_modality_stub(
            batch["tokens"].shape[0], cfg.n_modality_positions, cfg.d_model, step)
    if cfg.family == "encdec":
        batch["frames"] = sample_modality_stub(batch["tokens"].shape[0], seq_len, cfg.d_model,
                                               step)
    return batch


def build_batch_fn(cfg, batch_size: int, seq_len: int, coreset: str, coreset_k: int,
                   generator: torch.Generator | None = None, device=None) -> Callable[[int], dict]:
    """``batch_fn(step)``: the token stream's batch, or with ``coreset`` a
    batch drawn from the coreset of a corpus scored once on ``device`` (a
    random-projected bag of tokens, D = 32, as the reference featurizes);
    the selection's draws come from ``generator``. Either way ``augment``
    adds the config's modality stubs of the step."""
    stream = TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=seq_len)
    if coreset == "none":
        return lambda step: augment(cfg, sample_batch(stream, batch_size, step), step, seq_len)

    corpus = [sample_batch(stream, 64, s) for s in range(max(coreset_k // 16, 8))]
    data = {k: np.concatenate([c[k] for c in corpus]) for k in ("tokens", "labels")}
    rng = np.random.default_rng(0)
    proj = rng.standard_normal((cfg.vocab_size, 32)).astype(np.float32) * 0.05

    def featurize(tokens):  # cheap proxy: random-projected bag of tokens
        return proj[tokens].mean(axis=1)

    fn = coreset_subset_loader(data, featurize, method=coreset, k=coreset_k,
                               generator=generator, batch=batch_size, device=device)
    return lambda step: augment(cfg, fn(step), step, seq_len)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--coreset", default="none", choices=("none", "l2-hull", "l2-only", "uniform"))
    ap.add_argument("--coreset-k", type=int, default=512)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    return ap.parse_args(argv)


@dataclasses.dataclass
class TrainRun:
    """What ``run`` returns: the record (``losses`` of the steps this run
    took, from ``start``; ``step_s``, each step's host time, which ends in
    the loop's finiteness read of its loss; ``select_s``, the data stage)
    and the live objects, for a caller that steps on."""

    record: dict
    model: torch.nn.Module
    state: object
    step_fn: Callable
    batch_fn: Callable


def run(args: argparse.Namespace, cfg=None) -> TrainRun:
    """The driver's run; ``cfg`` (a caller's cut of ``--arch``'s config, for
    example fewer layers) replaces the config the arguments name."""
    dev = resolve_device(args.device)
    if cfg is None:
        cfg = get_reduced_config(args.arch) if args.reduced else get_config(args.arch)
    model = build_model(cfg, device=dev, seed=0, train=True)
    opt = chain(
        clip_by_global_norm(1.0),
        adamw(cosine_warmup(args.lr, warmup=20, total=args.steps)),
    )
    state = init_train_state(model.param_tree(), opt)
    mgr = CheckpointManager(args.ckpt_dir, keep=3) if args.ckpt_dir else None
    start = 0
    if mgr and args.resume:
        state, start = restore_train_state(mgr, state)
        if start:
            print(f"[resume] from step {start}", flush=True)

    t0 = time.perf_counter()
    batch_fn = build_batch_fn(cfg, args.batch, args.seq, args.coreset, args.coreset_k,
                              torch.Generator().manual_seed(SELECTION_SEED), dev)
    select_s = time.perf_counter() - t0
    step_fn = make_train_step(model, opt)
    stamps = []

    def timed_step(state, batch):
        stamps.append(time.perf_counter())
        return step_fn(state, batch)

    state, losses = train_loop(timed_step, state, batch_fn, args.steps, start=start, mgr=mgr,
                               ckpt_every=args.ckpt_every, log_every=args.log_every,
                               label="train")
    losses = [float(x) for x in losses]
    stamps.append(time.perf_counter())
    final = losses[-1] if losses else float("nan")
    print(f"done: {args.steps} steps, final loss {final:.4f}", flush=True)
    record = {"arch": cfg.name, "device": str(dev), "start": start, "steps": args.steps,
              "losses": losses, "step_s": list(np.diff(stamps)), "select_s": select_s,
              "tokens_per_step": args.batch * args.seq}
    return TrainRun(record, model, state, step_fn, batch_fn)


def main(argv=None) -> dict:
    return run(parse_args(argv)).record


if __name__ == "__main__":
    main()
