"""Rank bodies of the port's sharded-step and collective tests
(``tests/test_torch_shard_train_step*.py``, ``tests/test_torch_collectives.py``):
each runs on every rank of a spawned gloo world
(``repro_torch.distributed.run_world``) and returns what the parent
compares. Spawned ranks import this module, so it imports the port alone,
never the JAX package."""
import multiprocessing

import numpy as np
import torch

# a spawned rank pins itself to one intra-op thread (tests/torch_threads.py)
if multiprocessing.parent_process() is not None:
    torch.set_num_threads(1)

B, T = 8, 16


def lm_batch(cfg, seed: int) -> dict:
    """Tokens, labels, weights in [0.2, 3) and the config's modality stubs
    (N(0, 0.02²) patch embeddings or frames), numpy, from ``seed``."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, T + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "weights": rng.uniform(0.2, 3.0, B).astype(np.float32)}
    if cfg.modality == "vision":
        batch["patch_embeds"] = (rng.standard_normal((B, cfg.n_modality_positions, cfg.d_model))
                                 * 0.02).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = (rng.standard_normal((B, T + 3, cfg.d_model)) * 0.02).astype(np.float32)
    return batch


def optimizer(kind: str):
    """"warmup": the train-step tests' chain(clip(1.0), adamw(cosine warmup
    to 1e-2 over 2 steps)); "warmup_adamw": that adamw alone; "constant":
    adamw at 1e-2 (a single step that moves the weights)."""
    from repro_torch import optim as TO

    if kind == "warmup":
        return TO.chain(TO.clip_by_global_norm(1.0), TO.adamw(TO.cosine_warmup(1e-2, 2, 6)))
    if kind == "warmup_adamw":
        return TO.adamw(TO.cosine_warmup(1e-2, 2, 6))
    return TO.adamw(1e-2)


def lr_sum(kind: str, steps: int) -> float:
    from repro_torch import optim as TO

    if kind in ("warmup", "warmup_adamw"):
        return sum(float(TO.cosine_warmup(1e-2, 2, 6)(i)) for i in range(steps))
    return 1e-2 * steps


def run_steps(model, step, state, cfg, steps: int):
    losses, norms = [], []
    for i in range(steps):
        batch = {k: torch.as_tensor(v) for k, v in lm_batch(cfg, 100 + i).items()}
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return state, losses, norms


def _full(x):
    return (x.full_tensor() if hasattr(x, "full_tensor") else x).detach().numpy().copy()


def sharded_steps(mesh, shape, cases):
    """Every case (arch, steps, optimizer kind, microbatches[, weights]) of
    one world on the ("data", "model") mesh of ``shape``: the sharded
    step's losses, grad norms, params and AdamW moments after ``steps``
    steps (params and moments gathered, returned by rank 0; ``placements``
    by every rank). ``weights``, where given, are the JAX package's initial
    parameters as numpy (``models.model_from_jax``); else the port's seed 0."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.launch.mesh import device_mesh
    from repro_torch.models import build_model, model_from_jax
    from repro_torch.train import init_train_state, make_train_step, shard_train_step
    from repro_torch.train.state import tree_leaves

    dm = device_mesh(mesh, model=shape[1])
    out = {}
    for arch, steps, kind, mb, *weights in cases:
        cfg = get_reduced_config(arch).replace(dtype="float32")
        model = (model_from_jax(cfg, weights[0], device=mesh.device, train=True) if weights
                 else build_model(cfg, device=mesh.device, train=True, seed=0))
        opt = optimizer(kind)
        step, state_sh, _ = shard_train_step(make_train_step(model, opt, microbatches=mb),
                                             model, opt, dm)
        state = init_train_state(model.param_tree(), opt)
        state, losses, norms = run_steps(model, step, state, cfg, steps)
        adam = state.opt_state[1] if kind == "warmup" else state.opt_state
        params = [_full(p) for p in tree_leaves(state.params)]
        moments = {k: [_full(m) for m in adam[k]] for k in ("m", "v")}
        out[arch, mb] = {
            "losses": losses, "grad_norms": norms, "step": state.step,
            "placements": [str(tuple(p.placements)) for p in tree_leaves(state.params)],
            "params": params if mesh.rank == 0 else None,
            "moments": moments if mesh.rank == 0 else None,
        }
    return out


def unsharded_steps(arch, steps, kind, mb):
    """The same steps through ``make_train_step`` on one CPU process."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import build_model
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.train.state import tree_leaves

    cfg = get_reduced_config(arch).replace(dtype="float32")
    model = build_model(cfg, device="cpu", train=True, seed=0)
    opt = optimizer(kind)
    state = init_train_state(model.param_tree(), opt)
    state, losses, norms = run_steps(model, make_train_step(model, opt, microbatches=mb),
                                     state, cfg, steps)
    adam = state.opt_state[1] if kind == "warmup" else state.opt_state
    return {"losses": losses, "grad_norms": norms, "step": state.step,
            "params": [_full(p) for p in tree_leaves(state.params)],
            "moments": {k: [_full(m) for m in adam[k]] for k in ("m", "v")}}


# ---------------------------------------------------------------- collectives


def collectives(mesh, inp):
    """The ring and reduce-scatter matmuls (a "model" mesh of the world),
    the int8 all-reduce and compression with error feedback (the world's
    data axis), the GPipe forward (a "stage" mesh of the world), each on
    this rank's blocks of ``inp``'s arrays."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.distributed.collectives import (psum_quantized, reduce_scatter_matmul,
                                                     ring_allgather_matmul)
    from repro_torch.distributed.grad_compress import (compress_and_average, init_error_state,
                                                       topk_sparsify)
    from repro_torch.distributed.pipeline_parallel import pipeline_forward, split_stages

    R, r = mesh.world, mesh.rank
    ranks = torch.arange(R)
    model = DeviceMesh("cpu", ranks, mesh_dim_names=("model",))
    X, W = torch.tensor(inp["X"]), torch.tensor(inp["W"])
    k = X.shape[1] // R
    xs, ws = X[:, r * k:(r + 1) * k], W[r * k:(r + 1) * k]
    out = {"ring": ring_allgather_matmul(xs, ws, model, "model").numpy(),
           "rs": reduce_scatter_matmul(xs, ws, model, "model").numpy(),
           "psum_q": psum_quantized(torch.tensor(inp["Q"][r]), mesh, "data").numpy()}
    grads = {"a": torch.tensor(inp["GA"][r]), "b": torch.tensor(inp["GB"][r])}
    err = init_error_state(grads)
    avgs, errs = [], []
    for _ in range(2):  # two rounds: the second carries the first's residual
        avg, err = compress_and_average(grads, err, mesh, "data")
        avgs.append({k: v.numpy() for k, v in avg.items()})
        errs.append({k: v.numpy() for k, v in err.items()})
    out["compress_avg"], out["compress_err"] = avgs, errs
    out["topk"] = topk_sparsify(torch.tensor(inp["GA"][r]), 0.1).numpy()
    stage = DeviceMesh("cpu", ranks, mesh_dim_names=("stage",))
    layer_w = torch.tensor(inp["LW"])
    out["pipeline"] = pipeline_forward(torch.tensor(inp["XM"]), split_stages(layer_w, R),
                                       lambda w, h: torch.tanh(h @ w), stage).numpy()
    return out
