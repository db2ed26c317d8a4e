"""How close the sharded train step's cases come to their tolerances, on the
CPU: runs the worlds of ``tests/test_torch_shard_train_step.py`` (the
meshes, the seven other configs at (2, 2), and the JAX package's own
``shard_train_step`` beside the port's on its weights) and prints, per
case, the largest loss and moment errors relative to their tensors' largest
magnitude and the worst param leaf as a share of the tests' rule (1e-5 of
its largest magnitude plus 1e-3 of the steps' summed learning rates).

    PYTHONPATH=src python3 scripts/torch_shard_margins.py
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np

TESTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests")


def margins(got: dict, ref: dict, kind: str, steps: int) -> dict:
    from torch_shard_ranks import lr_sum

    bound = 1e-3 * lr_sum(kind, steps)
    params = [float(np.abs(g - r).max()) / (1e-5 * float(np.abs(r).max()) + bound)
              for g, r in zip(got["params"], ref["params"], strict=True)]
    moments = [float(np.abs(g - r).max()) / max(float(np.abs(r).max()), 1e-30)
               for k in ("m", "v") for g, r in zip(got["moments"][k], ref["moments"][k],
                                                   strict=True)]
    return {"loss_rel": max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"])),
            "moment_rel": max(moments), "param_share_of_rule": max(params),
            "worst_param_leaf": int(np.argmax(params))}


def main() -> None:
    sys.path.insert(0, TESTS)
    import test_torch_shard_train_step as T
    from test_torch_shard_train_step_zoo import STEPS as ZOO_STEPS
    from test_torch_shard_train_step_zoo import ZOO
    from torch_shard_ranks import unsharded_steps

    worlds = T.worlds._fixture_function()
    zoo = T.run_meshes({(2, 2): [(a, ZOO_STEPS, "warmup", 1) for a in ZOO]})[2, 2]
    for shape, cases in T.MESHES.items():
        for arch, steps, kind, mb in cases:
            got = worlds[shape][0][arch, mb]
            row = margins(got, unsharded_steps(arch, steps, kind, mb), kind, steps)
            print(json.dumps({"mesh": shape, "arch": arch, "microbatches": mb, **row}))
    for arch in ZOO:
        row = margins(zoo[0][arch, 1], unsharded_steps(arch, ZOO_STEPS, "warmup", 1), "warmup",
                      ZOO_STEPS)
        print(json.dumps({"mesh": (2, 2), "arch": arch, "microbatches": 1, **row}))
    row = margins(worlds["reference"][0][T.REFERENCE_ARCH, 1], worlds["reference_run"],
                  "warmup_adamw", T.STEPS)
    print(json.dumps({"mesh": (2, 2), "arch": T.REFERENCE_ARCH, "against": "the JAX package's "
                      "shard_train_step", **row}))


if __name__ == "__main__":
    main()
