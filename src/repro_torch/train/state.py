"""TrainState — the port of ``repro.train.state``: the step (a Python int),
the parameters (any tree: the LM's ``param_tree()``, the fit layer's
parameter tuple) and the optimizer's state. One class for the LM trainer
and the MCTM fit layer, as in the reference."""
from __future__ import annotations

from typing import Any, NamedTuple

from repro_torch.checkpoint.manager import flatten_with_names


class TrainState(NamedTuple):
    step: int
    params: Any
    opt_state: Any

    def replace(self, **kw) -> "TrainState":
        return self._replace(**kw)


def tree_leaves(tree) -> list:
    """A tree's leaves in the reference's flatten order (sorted dict keys,
    field and list order)."""
    return [x for _, x in flatten_with_names(tree)]


def init_train_state(params, optimizer) -> TrainState:
    """Step 0, ``params``, and ``optimizer.init`` of its leaves."""
    return TrainState(step=0, params=params, opt_state=optimizer.init(tree_leaves(params)))
