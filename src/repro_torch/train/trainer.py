"""Training and serving step functions — the port of ``repro.train.trainer``.

``make_train_step`` returns a step function over a ``TrainState`` whose
params are a training model's ``param_tree()``:

  * per-example weighted loss (coreset weights flow straight through);
  * optional microbatch gradient accumulation, in float32 in microbatch
    order, then scaled by 1/microbatches (the reference's ``lax.scan``);
  * the optimizer's update, applied to the masters in place.

``make_serve_steps`` returns the prefill and decode functions. The sharded
step (``shard_train_step``) waits for ROADMAP.md Queue A 14.9.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.optim import Optimizer, apply_updates
from repro_torch.train.state import TrainState, tree_leaves

__all__ = ["microbatch_split", "tree_acc", "loss_and_grads", "make_train_step",
           "make_serve_steps", "shard_train_step"]


def microbatch_split(batch: dict, microbatches: int) -> dict:
    """Reshape every batch leaf (b, ...) → (microbatches, b/microbatches, ...)
    (numpy arrays or tensors): the one chunk-geometry rule of the train step."""

    def reshape(x):
        b = x.shape[0]
        if b % microbatches:
            raise ValueError(f"a batch of {b} does not split into {microbatches} microbatches")
        return x.reshape(microbatches, b // microbatches, *x.shape[1:])

    return {k: reshape(v) for k, v in batch.items()}


def tree_acc(acc, new):
    """Accumulate ``new`` into ``acc`` (a tensor or a list of tensors) in
    ``acc``'s dtype."""
    if isinstance(acc, list):
        return [a + g.to(a.dtype) for a, g in zip(acc, new)]
    return acc + new.to(acc.dtype)


def loss_and_grads(model, params, batch: dict):
    """(loss, metrics, grads): ``model.loss_fn(batch)`` and its gradient
    with respect to the leaves of ``params`` (``model.param_tree()``, the
    tensors the loss reads), a list in flatten order."""
    loss, metrics = model.loss_fn(batch)
    grads = torch.autograd.grad(loss, tree_leaves(params))
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, list(grads)


def make_train_step(
    model,
    optimizer: Optimizer,
    *,
    microbatches: int = 1,
) -> Callable[[TrainState, dict], tuple[TrainState, dict]]:
    """``train_step(state, batch) -> (state, {"loss", "grad_norm", "step"})``.
    ``state.params`` is ``model.param_tree()``; the step updates those
    tensors in place and returns the state with the next step and the new
    optimizer state. The metrics stay on the device."""

    def accum_grads(params, batch):
        """Split the global batch into microbatches and accumulate grads."""
        mb = microbatch_split(batch, microbatches)
        leaves = tree_leaves(params)
        loss_acc = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        grads_acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
        for i in range(microbatches):
            loss, _, grads = loss_and_grads(model, params, {k: v[i] for k, v in mb.items()})
            loss_acc, grads_acc = tree_acc(loss_acc, loss), tree_acc(grads_acc, grads)
        scale = 1.0 / microbatches
        return loss_acc * scale, {}, [g * scale for g in grads_acc]

    def train_step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        fn = accum_grads if microbatches > 1 else (lambda p, b: loss_and_grads(model, p, b))
        loss, _, grads = fn(state.params, batch)
        leaves = tree_leaves(state.params)
        updates, opt_state = optimizer.update(grads, state.opt_state, leaves, state.step)
        apply_updates(leaves, updates)
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))
        out_metrics = {"loss": loss, "grad_norm": gnorm, "step": state.step}
        return state.replace(step=state.step + 1, opt_state=opt_state), out_metrics

    return train_step


def shard_train_step(*args, **kwargs):
    """The step under the sharding rules: not ported yet."""
    raise NotImplementedError("shard_train_step (the sharding rules): ROADMAP.md Queue A 14.9")


def make_serve_steps(model):
    """(prefill_fn, decode_fn): ``prefill(batch, cache)`` and
    ``decode(tokens, cache)``, the reference's pair without its params
    argument (the model holds its weights)."""

    def prefill(batch, cache):
        return model.prefill(batch, cache)

    def decode(tokens, cache):
        return model.decode_step(tokens, cache)

    return prefill, decode
