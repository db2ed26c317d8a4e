"""The port's LM dry run (``repro_torch.launch.dryrun``) and its shapes
(``launch/shapes.py``) against the JAX package's.

  * ``cell_supported`` (with its reason) and every input and cache spec of
    ``launch/shapes.py``, shapes and dtypes, for the ten published configs ×
    four shapes;
  * the reference's own dry-run cell (``tests/test_distributed.py``:
    reduced tinyllama, the (2, 2, 2) ("pod", "data", "model") mesh, batch
    8 × 16, two microbatches, remat "full", CE chunk 8): the port's
    per-rank argument bytes equal the sum of the reference's
    ``shard_shape`` sizes over the state and batch (less the reference's
    int32 step counter, which the port keeps on the host), and its traced
    FLOPs lie within 25% of XLA's ``cost_analysis`` (the bound of
    ``tests/test_torch_dryrun.py``) on the same cell at one layer. XLA
    counts a while loop's body once: the reference's layer scan runs its
    body twice at two layers, and XLA's count moves from 7,370,638 (one
    layer) to 7,390,447 (two), where the port's trace counts every
    iteration (6,029,312 → 10,485,760). At one layer the scan runs once and
    XLA counts all of it; there the port's count is 0.818 of XLA's (the
    port counts matmul-family ops only, XLA every op);
  * long_500k skipped for a full-attention arch with the reference's reason,
    and mamba2's long_500k cell on 2×16×16 traced without error.

The reference's figures come from one subprocess with 8 fake CPU devices."""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_thread  # noqa: E402,F401

from repro.configs import ARCH_NAMES  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch import shapes as RSh  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro_torch.configs import get_config, get_reduced_config  # noqa: E402
from repro_torch.launch import dryrun as TD  # noqa: E402
from repro_torch.launch import shapes as TSh  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
FLOPS_GAP = 0.25  # the bound of tests/test_torch_dryrun.py


def _dims(tree, jax_side: bool) -> list:
    import jax

    leaves = jax.tree.leaves(tree) if jax_side else tree_leaves(tree)
    return [(tuple(x.shape), np.dtype(x.dtype).name if jax_side
             else str(x.dtype).replace("torch.", "")) for x in leaves]


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_shapes_and_input_specs_are_the_references(arch):
    import jax

    jcfg, cfg = jax_config(arch), get_config(arch)
    jmodel = jax_build(jcfg)
    assert list(TSh.SHAPES) == list(RSh.SHAPES)
    for name, shape in RSh.SHAPES.items():
        tshape = TSh.SHAPES[name]
        assert (tshape.kind, tshape.seq_len, tshape.global_batch) == (
            shape.kind, shape.seq_len, shape.global_batch)
        assert TSh.cell_supported(cfg, tshape) == RSh.cell_supported(jcfg, shape)
        assert _dims(TSh.train_batch_specs(cfg, tshape), False) == _dims(
            RSh.train_batch_specs(jcfg, shape), True)
        assert _dims(TSh.prefill_batch_specs(cfg, tshape), False) == _dims(
            RSh.prefill_batch_specs(jcfg, shape), True)
        assert _dims(TSh.decode_token_specs(tshape), False) == _dims(
            RSh.decode_token_specs(shape), True)
        if shape.kind != "train" and RSh.cell_supported(jcfg, shape)[0]:
            jc = jax.eval_shape(lambda: jmodel.init_cache(shape.global_batch,
                                                          shape.seq_len)[0])
            tc, tcs = TSh.cache_shapes(None, cfg, tshape)
            assert _dims(tc, False) == _dims(jc, True), (arch, name)
            assert tcs == jax.tree.map(tuple, jmodel.init_cache(1, 2)[1],
                                       is_leaf=lambda s: isinstance(s, tuple))


REFERENCE_CELL = textwrap.dedent("""
    import json
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh
    from repro.configs import get_reduced_config
    from repro.models import build_model
    from repro.models.transformer import shapes_and_specs
    from repro.distributed.sharding import default_rules, resolve_tree, batch_specs, replicated
    from repro.train.trainer import make_train_step
    from repro.train.state import TrainState
    from repro.optim import adamw

    def nbytes(shapes, shardings):
        total = 0
        for x, s in zip(jax.tree.leaves(shapes), jax.tree.leaves(shardings)):
            total += int(np.prod(s.shard_shape(x.shape))) * np.dtype(x.dtype).itemsize
        return total

    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 2, 2), ("pod", "data", "model"))
    out = {}
    for layers in (2, 1):
        cfg = get_reduced_config("tinyllama_1b").replace(n_layers=layers)
        model = build_model(cfg, remat="full", xent_chunk=8)
        rules = default_rules(mesh)
        params_shapes, specs = shapes_and_specs(model)
        param_sh = resolve_tree(specs, params_shapes, mesh, rules)
        opt = adamw(1e-3)
        opt_shapes = jax.eval_shape(opt.init, params_shapes)
        opt_sh = resolve_tree(opt.state_specs(specs, params_shapes), opt_shapes, mesh, rules)
        state_shapes = TrainState(step=jax.ShapeDtypeStruct((), jnp.int32),
                                  params=params_shapes, opt_state=opt_shapes)
        state_sh = TrainState(step=replicated(mesh), params=param_sh, opt_state=opt_sh)
        b = {"tokens": jax.ShapeDtypeStruct((8, 16), jnp.int32),
             "labels": jax.ShapeDtypeStruct((8, 16), jnp.int32),
             "weights": jax.ShapeDtypeStruct((8,), jnp.float32)}
        b_sh = batch_specs(b, mesh, rules)
        step = make_train_step(model, opt, microbatches=2)
        with mesh:
            compiled = jax.jit(step, in_shardings=(state_sh, b_sh),
                               out_shardings=(state_sh, None)).lower(state_shapes, b).compile()
        ca = compiled.cost_analysis()
        ca = ca[0] if isinstance(ca, (list, tuple)) else ca
        out[layers] = {"flops": float(ca["flops"]), "params": nbytes(params_shapes, param_sh),
                       "opt_state": nbytes(opt_shapes, opt_sh), "batch": nbytes(b, b_sh),
                       "step": 4}
    print(json.dumps(out))
""")


def _port(layers: int) -> dict:
    return TD.lower_cell("tinyllama-1.1b", "train_4k",
                         cfg=get_reduced_config("tinyllama_1b").replace(n_layers=layers),
                         mesh_shape=(2, 2, 2), shape=TSh.ShapeConfig("reduced", "train", 16, 8),
                         microbatches=2, xent_chunk=8, remat="full")


@pytest.fixture(scope="module")
def reference_cells():
    """{layers: the reference's figures} of the cell at two layers and one."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", REFERENCE_CELL], env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return {int(k): v for k, v in json.loads(out.stdout.strip().splitlines()[-1]).items()}


@pytest.fixture(scope="module")
def reference_cell(reference_cells):
    return reference_cells[2]


@pytest.fixture(scope="module")
def port_cell():
    return _port(2)


def test_reduced_cell_argument_bytes_are_the_references(reference_cell, port_cell):
    got = port_cell["memory_analysis"]["argument_bytes"]
    for key in ("params", "opt_state", "batch"):
        assert got[key] == reference_cell[key], key
    assert port_cell["memory_analysis"]["argument_size_in_bytes"] == (
        sum(reference_cell[k] for k in ("params", "opt_state", "batch", "step"))
        - reference_cell["step"])


def test_reduced_cell_flops_are_near_the_references(reference_cells, port_cell):
    one = _port(1)
    ratio = one["hlo_flops"] / reference_cells[1]["flops"]
    assert abs(ratio - 1.0) <= FLOPS_GAP, ratio
    # the second layer adds a layer's work to the port's count, where XLA
    # counts the scan's body once
    assert port_cell["hlo_flops"] > 1.5 * one["hlo_flops"]
    assert reference_cells[2]["flops"] < 1.01 * reference_cells[1]["flops"]
    assert port_cell["kind"] == "train" and port_cell["chips"] == 8
    assert port_cell["collective_by_op"]["all_reduce_pod"]["bytes"] == (
        reference_cells[2]["params"])
    assert "microbatch_split" in port_cell["redistributions"]
    assert port_cell["peak_memory_bytes"] >= port_cell["memory_analysis"][
        "argument_size_in_bytes"]


def test_long_context_cells():
    rec = TD.lower_cell("tinyllama-1.1b", "long_500k")
    assert rec == {"arch": "tinyllama-1.1b", "shape": "long_500k", "skipped": True,
                   "reason": RSh.cell_supported(jax_config("tinyllama_1b"),
                                                RSh.SHAPES["long_500k"])[1]}
    rec = TD.lower_cell("mamba2-370m", "long_500k", multi_pod=True)
    assert not rec["skipped"] and rec["kind"] == "decode" and rec["chips"] == 512
    assert rec["fits"] and rec["dominant"] in ("compute", "memory", "collective")
    assert rec["hlo_flops"] > 0 and rec["memory_analysis"]["argument_size_in_bytes"] > 0
