"""Training and serving step functions — the port of ``repro.train.trainer``.

``make_train_step`` returns a step function over a ``TrainState`` whose
params are a training model's ``param_tree()``:

  * per-example weighted loss (coreset weights flow straight through);
  * optional microbatch gradient accumulation, in float32 in microbatch
    order, then scaled by 1/microbatches (the reference's ``lax.scan``);
  * the optimizer's update, applied to the masters in place.

``shard_train_step`` runs that step on DTensors over a ``DeviceMesh`` whose
dimension names are the reference's mesh axes: the parameters and the
optimizer state are distributed by their resolved logical specs
(``distributed/sharding.py``: FSDP "embed → data", the model axis for heads,
mlp, vocab, experts), the batch is sharded on its leading dim, and
DTensor's sharding propagation places every op between (the reference's
GSPMD). Where DTensor has no sharding rule for an op of the model, the
model redistributes the operand explicitly at a named point
(``distributed/sharding.py``), which acts only inside the step's
``sharding.dtensor_run()``. ``make_serve_steps`` returns the prefill and decode
functions.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.distributed.sharding import dtensor_run, is_dtensor, split_microbatches
from repro_torch.optim import Optimizer, apply_updates
from repro_torch.train.state import TrainState
from repro_torch.utils.tree import tree_leaves, tree_map

__all__ = ["microbatch_split", "tree_acc", "loss_and_grads", "make_train_step",
           "make_serve_steps", "shard_train_step"]


def microbatch_split(batch: dict, microbatches: int) -> dict:
    """Reshape every batch leaf (b, ...) → (microbatches, b/microbatches, ...)
    (numpy arrays or tensors): the one chunk-geometry rule of the train step."""

    def reshape(x):
        b = x.shape[0]
        if b % microbatches:
            raise ValueError(f"a batch of {b} does not split into {microbatches} microbatches")
        return split_microbatches("microbatch_split", x, microbatches)

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
        grads_acc = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
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


def shard_train_step(
    train_step,
    model,
    optimizer: Optimizer,
    mesh,
    rules=None,
    *,
    params_shapes=None,
    specs=None,
    batch_shapes: dict | None = None,
    donate: bool = True,
):
    """The step with the parameters, the optimizer state and the batch
    distributed by their resolved logical specs over the ``DeviceMesh``
    ``mesh``. Returns ``(step, state_shardings, batch_shardings)``:
    ``TrainState``-shaped and dict trees of ``sharding.NamedSharding``
    (``batch_shardings`` None without ``batch_shapes``: the batch's own
    leaves are then sharded on their leading dim).

    ``step(state, batch)`` takes ``init_train_state(model.param_tree(),
    optimizer)`` with the same values on every rank (a rank keeps its
    shards; nothing is sent) or a state it returned, and a global batch,
    the same on every rank; it returns the sharded state and the metrics
    as plain tensors, the same on every rank. The first call distributes
    the model's masters in place (its ``param_tree()`` then holds
    DTensors), as the reference's jit moves its arguments to their
    shardings. Collective: every rank calls it. ``donate`` is the
    reference's argument: the state's tensors are always reused."""
    from repro_torch.distributed.sharding import (batch_specs, default_rules, replicated,
                                                  resolve_tree)

    del donate  # the step updates the masters in place, as a donated jit would
    rules = rules or default_rules(mesh)
    if params_shapes is None or specs is None:
        from repro_torch.models.transformer import shapes_and_specs

        params_shapes, specs = shapes_and_specs(model)
    param_sh = resolve_tree(specs, params_shapes, mesh, rules)
    opt_shapes = optimizer.init(tree_leaves(_on_meta(params_shapes)))
    if optimizer.state_specs is not None:
        opt_sh = resolve_tree(optimizer.state_specs(specs, params_shapes), opt_shapes, mesh, rules)
    else:
        opt_sh = tree_map(lambda _: replicated(mesh), opt_shapes)
    state_sh = TrainState(step=replicated(mesh), params=param_sh, opt_state=opt_sh)
    batch_sh = batch_specs(batch_shapes, mesh, rules) if batch_shapes is not None else None

    def shard_state(state: TrainState) -> TrainState:
        """``state`` with the model's masters distributed in place and the
        optimizer state sharded (a state already sharded as it is)."""
        if is_dtensor(tree_leaves(state.params)[0]):
            return state
        _distribute_masters(model, state.params, param_sh)
        return state.replace(params=model.param_tree(),
                             opt_state=_shard_tree(state.opt_state, opt_sh))

    def step(state: TrainState, batch: dict):
        from torch.distributed.tensor.experimental import implicit_replication

        state = shard_state(state)
        sh = batch_sh if batch_sh is not None else batch_specs(batch, mesh, rules)
        dev = tree_leaves(state.params)[0].device
        batch = {k: _distribute(torch.as_tensor(v).to(dev), sh[k]) for k, v in batch.items()}
        with implicit_replication(), dtensor_run():
            state, metrics = train_step(state, batch)
        state = state.replace(opt_state=_shard_tree(state.opt_state, opt_sh))
        return state, {k: _plain(v) for k, v in metrics.items()}

    step.shard_state = shard_state
    return step, state_sh, batch_sh


def _on_meta(tree):
    return tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta"), tree)


def _distribute(x: torch.Tensor, sharding):
    """``x`` (the same full tensor on every rank) as a DTensor of
    ``sharding``, or redistributed to it if it is one: a rank keeps its own
    block and sends nothing (``src_data_rank=None``)."""
    from torch.distributed.tensor import distribute_tensor

    if is_dtensor(x):
        return x.redistribute(sharding.mesh, sharding.placements)
    return distribute_tensor(x, sharding.mesh, sharding.placements, src_data_rank=None)


def _shard_tree(tree, shardings):
    return tree_map(lambda sh, x: _distribute(x, sh), shardings, tree,
                    is_leaf=lambda n: hasattr(n, "placements"))


def _plain(x):
    """A metric as a plain tensor (collective for a DTensor)."""
    return x.full_tensor() if is_dtensor(x) else x


def _distribute_masters(model, params, shardings) -> None:
    """Replace each of the model's master parameters (the leaves of
    ``params``, its ``param_tree()``) with a DTensor parameter of its
    sharding, in the ``ParameterDict`` that holds it."""
    from torch import nn

    owner = {}
    for mod in model.modules():
        if isinstance(mod, nn.ParameterDict):
            for k, p in mod.items():
                owner[id(p)] = (mod, k)
    for p, sh in zip(tree_leaves(params),
                     tree_leaves(shardings, is_leaf=lambda n: hasattr(n, "placements"))):
        mod, k = owner[id(p)]
        mod[k] = nn.Parameter(_distribute(p.detach(), sh), requires_grad=p.requires_grad)


def make_serve_steps(model):
    """(prefill_fn, decode_fn): ``prefill(batch, cache)`` and
    ``decode(tokens, cache)``, the reference's pair without its params
    argument (the model holds its weights)."""

    def prefill(batch, cache):
        return model.prefill(batch, cache)

    def decode(tokens, cache):
        return model.decode_step(tokens, cache)

    return prefill, decode
