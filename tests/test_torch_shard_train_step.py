"""The port's sharded train step (``train.shard_train_step``: DTensors on a
("data", "model") ``DeviceMesh``) against its unsharded ``make_train_step``
on the same weights and batches, in spawned CPU gloo worlds: reduced
tinyllama, qwen2-moe (MoE) and mamba2 (SSM) at f32 on the meshes (2, 1),
(1, 2) and (2, 2), three steps of the train-step tests' optimizer
(``chain(clip_by_global_norm(1.0), adamw(cosine_warmup(1e-2, 2, 6)))``),
and tinyllama at (2, 2) with two microbatches (the "microbatch_split"
redistribution). One world per mesh shape runs all of its cases; the three
run at once. The other seven reduced configs take one step at (2, 2) in
``test_torch_shard_train_step_zoo.py``.

Tolerances, relative to each tensor's largest magnitude: 1e-5 for the
losses, grad norms and AdamW moments (f32; the moments are linear in the
gradients). Params: the rule of ``tests/test_torch_train_step.py``, 1e-5 of
their largest magnitude plus 1e-3 of the sum of the steps' learning rates
(AdamW moves a weight by about lr·m̂/√v̂ whatever the size of its gradient).
The worst leaf of all these cases measured 0.37 of that bound
(recurrentgemma's at (2, 2); ``scripts/torch_shard_margins.py``).

``test_sharded_step_matches_the_reference_sharded_step`` holds the port's
sharded step to the JAX package's own ``shard_train_step`` (GSPMD over a
(2, 2) ("data", "model") mesh of XLA host devices, one subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=8``): reduced tinyllama
from the reference's initial weights, the same batches, three steps of
``adamw(cosine_warmup(1e-2, 2, 6))`` without the clip (the reference's
``shard_train_step`` cannot shard a ``chain``'s state: its spec-leaf rule
takes the chain's tuple of state specs for one spec), the same
tolerances."""
import os
import pickle
import subprocess
import sys
import tempfile
import textwrap
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_shard_ranks import lm_batch, lr_sum, sharded_steps, unsharded_steps  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401

from repro_torch.distributed import run_world  # noqa: E402

REL = 1e-5
PARAM_LR = 1e-3
SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
CORE = ("tinyllama_1b", "qwen2_moe_a2_7b", "mamba2_370m")
STEPS = 3
REFERENCE_ARCH = "tinyllama_1b"
MESHES = {(2, 1): [(a, STEPS, "warmup", 1) for a in CORE],
          (1, 2): [(a, STEPS, "warmup", 1) for a in CORE],
          (2, 2): [(a, STEPS, "warmup", 1) for a in CORE] + [("tinyllama_1b", STEPS, "warmup", 2)]}


def run_meshes(meshes: dict, extra: dict | None = None) -> dict:
    """{mesh shape: rank results} of one gloo world per shape, run at once,
    with the worlds of ``extra`` ({key: (mesh shape, cases)}) beside them
    under their keys."""
    worlds = {shape: (shape, cases) for shape, cases in meshes.items()} | dict(extra or {})
    with ThreadPoolExecutor(len(worlds)) as pool:
        futs = {key: pool.submit(run_world, sharded_steps, shape[0] * shape[1],
                                 backend="gloo", devices=["cpu"] * (shape[0] * shape[1]),
                                 args=(shape, cases), timeout_s=900)
                for key, (shape, cases) in worlds.items()}
        return {key: f.result() for key, f in futs.items()}


def check_case(ranks: list, ref: dict, kind: str, steps: int, what: str) -> None:
    """Every rank's losses and grad norms, and rank 0's gathered params and
    moments, against the unsharded step's (module doc's tolerances)."""
    for r, got in enumerate(ranks):
        assert got["step"] == ref["step"] == steps, what
        for key in ("losses", "grad_norms"):
            np.testing.assert_allclose(got[key], ref[key], rtol=REL, atol=0,
                                       err_msg=f"{what} rank {r} {key}")
    got = ranks[0]
    for key in ("m", "v"):
        for i, (g, w) in enumerate(zip(got["moments"][key], ref["moments"][key], strict=True)):
            err = float(np.abs(g - w).max())
            assert err <= REL * max(float(np.abs(w).max()), 1e-30), f"{what} {key} {i}: {err:.3e}"
    bound_lr = PARAM_LR * lr_sum(kind, steps)
    for i, (g, w) in enumerate(zip(got["params"], ref["params"], strict=True)):
        err = float(np.abs(g - w).max())
        assert err <= REL * float(np.abs(w).max()) + bound_lr, f"{what} param {i}: {err:.3e}"


@pytest.fixture(scope="module")
def worlds():
    """The worlds of MESHES, and beside them the JAX package's sharded run
    of REFERENCE_ARCH (a subprocess) and the port's (2, 2) world on the
    reference's initial weights, all at once."""
    import jax

    from repro.configs import get_reduced_config as jax_config
    from repro.models import build_model as jax_build
    from repro_torch.configs import get_reduced_config

    params, _ = jax_build(jax_config(REFERENCE_ARCH).replace(dtype="float32")).init(
        jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, params)
    batches = [lm_batch(get_reduced_config(REFERENCE_ARCH), 100 + i) for i in range(STEPS)]
    with tempfile.TemporaryDirectory() as tmp:
        inp, out = os.path.join(tmp, "in.pkl"), os.path.join(tmp, "out.pkl")
        with open(inp, "wb") as f:
            pickle.dump((REFERENCE_ARCH, batches), f)
        env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
                   JAX_PLATFORMS="cpu", PYTHONPATH=SRC)
        proc = subprocess.Popen([sys.executable, "-c", REFERENCE_STEP, inp, out], env=env,
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            res = run_meshes(MESHES, {"reference": ((2, 2), [
                (REFERENCE_ARCH, STEPS, "warmup_adamw", 1, init)])})
            _, err = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        assert proc.returncode == 0, err[-3000:]
        with open(out, "rb") as f:
            res["reference_run"] = pickle.load(f)
    for a, b in zip(jax.tree.leaves(init), jax.tree.leaves(res["reference_run"]["init"]),
                    strict=True):
        np.testing.assert_array_equal(a, b)  # the same initial weights in both processes
    return res


@pytest.fixture(scope="module")
def unsharded():
    return {(a, mb): unsharded_steps(a, STEPS, "warmup", mb)
            for cases in MESHES.values() for a, _, _, mb in cases}


@pytest.mark.parametrize("shape", list(MESHES), ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", CORE)
def test_sharded_step_matches_the_unsharded_step(worlds, unsharded, shape, arch):
    ranks = [res[arch, 1] for res in worlds[shape]]
    check_case(ranks, unsharded[arch, 1], "warmup", STEPS, f"{arch} {shape}")


def test_sharded_step_with_microbatches(worlds, unsharded):
    ranks = [res["tinyllama_1b", 2] for res in worlds[2, 2]]
    check_case(ranks, unsharded["tinyllama_1b", 2], "warmup", STEPS, "tinyllama mb 2")


def test_params_are_sharded_by_the_rules(worlds):
    """On (2, 2) the embedding is split over data on its embed dim (FSDP)
    and over model on its vocab; a norm scale over data only; on (2, 1)
    the vocab stays whole over the model axis of one rank (the reference's
    spec names the axis; one block either way)."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.models.transformer import shapes_and_specs
    from repro_torch.train.state import tree_leaves
    from repro_torch.checkpoint.manager import flatten_with_names

    shapes, _ = shapes_and_specs(get_reduced_config("tinyllama_1b"))
    names = [n for n, _ in flatten_with_names(shapes)]
    assert len(names) == len(tree_leaves(shapes))
    for shape, want in (((2, 2), {"emb.embed": "(Shard(dim=1), Shard(dim=0))",
                                  "ln_f.scale": "(Shard(dim=0), Replicate())"}),
                        ((2, 1), {"emb.embed": "(Shard(dim=1), Replicate())"})):
        for rank in worlds[shape]:
            got = dict(zip(names, rank["tinyllama_1b", 1]["placements"], strict=True))
            for name, placements in want.items():
                assert got[name] == placements, (shape, name, got[name])


REFERENCE_STEP = textwrap.dedent("""
    import pickle, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro import optim as RO
    from repro.configs import get_reduced_config
    from repro.models import build_model
    from repro.train import init_train_state, make_train_step
    from repro.train.trainer import shard_train_step
    from repro.utils.compat import make_mesh

    with open(sys.argv[1], "rb") as f:
        arch, batches = pickle.load(f)
    mesh = make_mesh((2, 2), ("data", "model"))
    jm = build_model(get_reduced_config(arch).replace(dtype="float32"))
    params, _ = jm.init(jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, params)
    opt = RO.adamw(RO.cosine_warmup(1e-2, 2, 6))
    shapes = {k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in batches[0].items()}
    step, state_sh, _ = shard_train_step(make_train_step(jm, opt), jm, opt, mesh,
                                         batch_shapes=shapes)
    state = jax.device_put(init_train_state(params, opt), state_sh)
    losses, norms = [], []
    with mesh:
        for b in batches:
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    adam = state.opt_state
    out = {"init": init, "losses": losses, "grad_norms": norms, "step": int(state.step),
           "params": [np.asarray(x) for x in jax.tree.leaves(state.params)],
           "moments": {k: [np.asarray(x) for x in jax.tree.leaves(adam[k])] for k in ("m", "v")}}
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)
""")


def test_sharded_step_matches_the_reference_sharded_step(worlds):
    ranks = [res[REFERENCE_ARCH, 1] for res in worlds["reference"]]
    check_case(ranks, worlds["reference_run"], "warmup_adamw", STEPS,
               f"{REFERENCE_ARCH} (2, 2) against the reference's")
