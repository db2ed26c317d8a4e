"""TrainState — the port of ``repro.train.state``: the step (a Python int),
the parameters (any tree: the LM's ``param_tree()``, the fit layer's
parameter tuple) and the optimizer's state. One class for the LM trainer
and the MCTM fit layer, as in the reference."""
from __future__ import annotations

from typing import Any, NamedTuple

from repro_torch.utils.tree import tree_leaves  # noqa: F401  (the flatten order, re-exported)


class TrainState(NamedTuple):
    step: int
    params: Any
    opt_state: Any

    def replace(self, **kw) -> "TrainState":
        return self._replace(**kw)


def init_train_state(params, optimizer) -> TrainState:
    """Step 0, ``params``, and ``optimizer.init`` of its leaves."""
    return TrainState(step=0, params=params, opt_state=optimizer.init(tree_leaves(params)))
