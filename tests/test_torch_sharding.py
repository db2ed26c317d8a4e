"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the JAX package's: the six cases of ``tests/test_sharding.py``; every
parameter, optimizer-state, batch and cache leaf of the ten published
configs × four shapes × both production meshes resolved to the reference's
``PartitionSpec`` (no devices: the reference's ``shapes_and_specs`` /
``eval_shape`` against the port's meta tensors, on a ``FakeMesh``); and on
a (2, 2, 2) ("pod", "data", "model") mesh, rank r's DTensor block of a few
specs equal to the reference's block on device r
(``NamedSharding.devices_indices_map``, one subprocess with 8 fake CPU
devices), which fixes the pod-major order of a dim split over ("pod",
"data")."""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401

from repro import optim as RO  # noqa: E402
from repro.configs import ARCH_NAMES  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.distributed import sharding as RS  # noqa: E402
from repro.launch import shapes as RSh  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models.transformer import shapes_and_specs as jax_shapes_and_specs  # noqa: E402
from repro.utils.tree import is_spec_leaf as jax_is_spec  # noqa: E402
from repro_torch import optim as TO  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import sharding as TS  # noqa: E402
from repro_torch.launch import shapes as TSh  # noqa: E402
from repro_torch.models.transformer import shapes_and_specs  # noqa: E402
from repro_torch.utils.tree import is_spec_leaf, tree_leaves  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")


class FakeMesh:
    """Minimal mesh stub (axis_names + shape dict), as tests/test_sharding.py's."""

    def __init__(self, shape: dict):
        self._shape = shape

    @property
    def shape(self):
        return self._shape

    @property
    def axis_names(self):
        return tuple(self._shape)


MESH = FakeMesh({"data": 16, "model": 16})
MESH_MP = FakeMesh({"pod": 2, "data": 16, "model": 16})


def _rules(M, mesh):
    multi_pod = "pod" in mesh.axis_names
    return M.ShardingRules({
        "batch": ("pod", "data") if multi_pod else ("data",),
        "embed": ("data",), "heads": ("model",), "kv": ("model",), "mlp": ("model",),
        "vocab": ("model",), "expert": ("model",), "lru": ("model",), "state": None,
        "layer": None, None: None})


# tests/test_sharding.py's cases: (logical, shape, mesh, rules, expected)
CASES = {
    "divisible_dims_shard": (("embed", "heads"), (2048, 4096), MESH, None,
                             PartitionSpec("data", "model")),
    "non_divisible_falls_back_to_replicated": (
        ("layer", "batch", None, "kv", None), (18, 128, 32768, 1, 256), MESH, None,
        PartitionSpec(None, "data", None, None, None)),
    "multi_pod_batch_axes": (("batch", None), (512, 4096), MESH_MP, None,
                             PartitionSpec(("pod", "data"), None)),
    "batch_not_divisible_by_pod_product": (("batch", None), (100, 4), MESH_MP, None,
                                           PartitionSpec(None, None)),
    "axis_used_once": (("a", "b"), (64, 64), MESH,
                       {"a": ("model",), "b": ("model",), None: None},
                       PartitionSpec("model", None)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_resolve_spec_cases(name):
    logical, shape, mesh, rules, want = CASES[name]
    rp = RS.ShardingRules(rules) if rules else _rules(RS, mesh)
    tp = TS.ShardingRules(rules) if rules else _rules(TS, mesh)
    ref = RS.resolve_spec(logical, shape, mesh, rp)
    got = TS.resolve_spec(logical, shape, mesh, tp)
    assert ref == want
    assert tuple(got) == tuple(want) and got == tuple(ref)


def test_default_rules_on_a_mesh_of_one():
    for mesh in (FakeMesh({"data": 1, "model": 1}),):
        rules = TS.default_rules(mesh)
        assert rules.get("batch") == ("data",) and rules.get("heads") == ("model",)
        assert rules.get("embed") == ("data",)
        assert TS.default_rules(mesh, fsdp=False).get("embed") is None
    assert TS.default_rules(MESH_MP).get("batch") == ("pod", "data")
    assert RS.default_rules(MESH_MP).rules == TS.default_rules(MESH_MP).rules


def _resolved(M, specs, shapes, mesh, rules, is_leaf):
    """The resolved PartitionSpec of every leaf (flatten order), as tuples."""
    sl = (jax.tree.leaves(specs, is_leaf=is_leaf) if M is RS
          else tree_leaves(specs, is_leaf=is_leaf))
    xl = jax.tree.leaves(shapes) if M is RS else tree_leaves(shapes)
    assert len(sl) == len(xl)
    return [tuple(M.resolve_spec(tuple(s), tuple(x.shape), mesh, rules)) for s, x in zip(sl, xl)]


def _dims(tree, M) -> list:
    leaves = jax.tree.leaves(tree) if M is RS else tree_leaves(tree)
    return [(tuple(x.shape), np.dtype(x.dtype).name if M is RS
             else str(x.dtype).replace("torch.", "")) for x in leaves]


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_every_leaf_resolves_to_the_references_spec(arch):
    jcfg, cfg = jax_config(arch), get_config(arch)
    jmodel = jax_build(jcfg)
    jshapes, jspecs = jax_shapes_and_specs(jmodel)
    shapes, specs = shapes_and_specs(cfg)
    assert _dims(shapes, TS) == _dims(jshapes, RS)
    ropt, topt = ((RO.adafactor(1e-4), TO.adafactor(1e-4)) if arch == "arctic_480b"
                  else (RO.adamw(3e-4), TO.adamw(3e-4)))
    jopt_shapes = jax.eval_shape(ropt.init, jshapes)
    jopt_specs = ropt.state_specs(jspecs, jshapes)
    meta = [torch.empty(x.shape, dtype=x.dtype, device="meta") for x in tree_leaves(shapes)]
    opt_shapes = topt.init(meta)
    opt_specs = topt.state_specs(specs, shapes)
    assert _dims(opt_shapes, TS) == _dims(jopt_shapes, RS)
    for mesh in (MESH, MESH_MP):
        for fsdp in (True, False):  # training's rules and serving's
            rr, tr = RS.default_rules(mesh, fsdp=fsdp), TS.default_rules(mesh, fsdp=fsdp)
            assert (_resolved(TS, specs, shapes, mesh, tr, is_spec_leaf)
                    == _resolved(RS, jspecs, jshapes, mesh, rr, jax_is_spec)), (arch, fsdp)
        rr, tr = RS.default_rules(mesh), TS.default_rules(mesh)
        assert (_resolved(TS, opt_specs, opt_shapes, mesh, tr, is_spec_leaf)
                == _resolved(RS, jopt_specs, jopt_shapes, mesh, rr, jax_is_spec)), arch
        for name, shape in RSh.SHAPES.items():
            tshape = TSh.SHAPES[name]
            if not RSh.cell_supported(jcfg, shape)[0]:
                continue
            serve = shape.kind != "train"
            rr, tr = RS.default_rules(mesh, fsdp=not serve), TS.default_rules(mesh, fsdp=not serve)
            if shape.kind == "train":
                jb, tb = RSh.train_batch_specs(jcfg, shape), TSh.train_batch_specs(cfg, tshape)
            elif shape.kind == "prefill":
                jb, tb = RSh.prefill_batch_specs(jcfg, shape), TSh.prefill_batch_specs(cfg, tshape)
            else:
                jb = {"tokens": RSh.decode_token_specs(shape)}
                tb = {"tokens": TSh.decode_token_specs(tshape)}
            want = {k: tuple(RS.resolve_spec(("batch",) + (None,) * (len(v.shape) - 1),
                                             v.shape, mesh, rr)) for k, v in jb.items()}
            assert {k: tuple(v.spec) for k, v in TS.batch_specs(tb, mesh, tr).items()} == want
            if serve:
                # the reference dry run's way: its launch.shapes.cache_shapes hands
                # eval_shape the specs' strings too, which jax refuses
                jc = jax.eval_shape(lambda: jmodel.init_cache(shape.global_batch,
                                                              shape.seq_len)[0])
                jcs = jmodel.init_cache(1, 2)[1]
                tc, tcs = TSh.cache_shapes(None, cfg, tshape)
                assert _dims(tc, TS) == _dims(jc, RS), (arch, name)
                assert (_resolved(TS, tcs, tc, mesh, tr, is_spec_leaf)
                        == _resolved(RS, jcs, jc, mesh, rr, jax_is_spec)), (arch, name)


# ---------------------------------------------------------------- pod-major order

SPECS_222 = [PartitionSpec(("pod", "data"), "model"), PartitionSpec("data", "model"),
             PartitionSpec(None, ("pod", "data")), PartitionSpec("model", None),
             PartitionSpec(("pod", "data", "model"), None)]

REFERENCE_222 = textwrap.dedent("""
    import json, sys
    import jax, numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 2, 2), ("pod", "data", "model"))
    specs = [P(("pod", "data"), "model"), P("data", "model"), P(None, ("pod", "data")),
             P("model", None), P(("pod", "data", "model"), None)]
    out = []
    for spec in specs:
        idx = NamedSharding(mesh, spec).devices_indices_map((8, 8))
        blocks = {}
        for dev, sl in idx.items():
            coords = [int(c) for c in np.argwhere(mesh.devices == dev)[0]]
            blocks[json.dumps(coords)] = [[s.start or 0, 8 if s.stop is None else s.stop]
                                          for s in sl]
        out.append(blocks)
    print(json.dumps(out))
""")


def _port_blocks(rank: int) -> list:
    """Rank ``rank``'s DTensor blocks of SPECS_222 on a (2, 2, 2) mesh of a
    fake world of 8 (each rank in a world of its own)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=8)
    try:
        mesh = init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=("pod", "data", "model"))
        full = torch.arange(64.0).reshape(8, 8)
        return [distribute_tensor(full, mesh, TS.to_placements(spec, mesh),
                                  src_data_rank=None).to_local().clone() for spec in SPECS_222]
    finally:
        dist.destroy_process_group()


def test_rank_blocks_are_the_references_device_blocks():
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", REFERENCE_222], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    ref = json.loads(out.stdout.strip().splitlines()[-1])
    full = torch.arange(64.0).reshape(8, 8)
    for rank in range(8):
        coords = json.dumps([int(c) for c in np.unravel_index(rank, (2, 2, 2))])
        for spec, got, blocks in zip(SPECS_222, _port_blocks(rank), ref, strict=True):
            (r0, r1), (c0, c1) = blocks[coords]
            assert torch.equal(got, full[r0:r1, c0:c1]), (rank, spec)
