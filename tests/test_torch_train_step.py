"""The port's train step against the JAX package's ``make_train_step`` on
the same weights and batches (reduced tinyllama, mamba2, minicpm3 (MLA),
qwen2-moe and arctic (MoE), olmo-1b, gemma-2b, phi-3-vision (patch
prefix) and whisper-medium (encdec) at f32):
``chain(clip_by_global_norm(1.0), adamw(cosine_warmup(...)))`` at 1 and 2
microbatches, the losses, grad norms, params and moments after 3 steps; one
step from a reference ``TrainState`` carried across (step 2 of a reference
run, moments and all), and for the MoE expert stacks (L, E, d, f) one step
from a carried adamw or adafactor state (adafactor factors their last two
axes).

Tolerances, relative to each tensor's largest magnitude: 1e-5 for losses
and grad norms (f32, as ``tests/test_torch_lm.py``) and for the moments,
which are linear in the gradients. Params: 1e-5 of their largest magnitude
plus 1e-3 of the sum of the steps' learning rates. AdamW moves a weight by
about lr·m̂/√v̂ whatever the size of its gradient, so a gradient 1e-5 of
the largest or smaller, whose relative error under the f32 tolerance can
reach 1e-3 and beyond, moves its weight by that share of lr (observed:
1.3e-6 at Σ lr = 1.5e-2, in mamba2's tied embedding)."""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch_train_cases import one_thread, with_stubs  # noqa: E402,F401

from repro.configs import get_reduced_config as jax_config  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro import optim as RO  # noqa: E402
from repro.train import init_train_state as jax_init_state  # noqa: E402
from repro.train import make_train_step as jax_train_step  # noqa: E402
from repro_torch import optim as TO  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.models import model_from_jax  # noqa: E402
from repro_torch.models.convert import train_state_from_jax  # noqa: E402
from repro_torch.train import init_train_state, make_train_step  # noqa: E402
from repro_torch.train.state import tree_leaves  # noqa: E402

REL = 1e-5


def _close(got, ref, rel, what):
    ref = np.asarray(ref, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape, what
    err = float(np.abs(got - ref).max())
    assert err <= rel * max(float(np.abs(ref).max()), 1e-30), f"{what}: max err {err:.3e}"


def SCHEDULE(M):
    return M.cosine_warmup(1e-2, 2, 6)


def _opt(M):
    return M.chain(M.clip_by_global_norm(1.0), M.adamw(SCHEDULE(M)))


def _batches(cfg, n, B=4, T=16, seed=0):
    """n batches of ``cfg``'s vocabulary, with its modality stubs."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, cfg.vocab_size, (B, T + 1)).astype(np.int32)
        out.append(with_stubs(cfg, {"tokens": toks[:, :-1], "labels": toks[:, 1:],
                                    "weights": rng.uniform(0.2, 3.0, B).astype(np.float32)}, rng))
    return out


@functools.lru_cache(maxsize=None)
def _jax_run(arch, microbatches):
    """The reference's 3 steps (one jitted step function per case; the
    carried-state test reuses the 1-microbatch run)."""
    jm = jax_build(jax_config(arch).replace(dtype="float32"))
    batches = _batches(jm.cfg, 3, seed=microbatches)
    params, _ = jm.init(jax.random.PRNGKey(0))
    opt = _opt(RO)
    state = jax_init_state(params, opt)
    step = jax.jit(jax_train_step(jm, opt, microbatches=microbatches))
    states, metrics = [state], []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        states.append(state)
        metrics.append(m)
    return batches, states, metrics


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _check_state(state, ref, what):
    """The port's TrainState (params: the model's tree; moments: lists in
    its flatten order) against a reference one."""
    assert state.step == int(ref.step), what
    clip_state, adam = state.opt_state
    assert clip_state == {} and ref.opt_state[0] == {}
    for key in ("m", "v"):
        for i, (g, r) in enumerate(zip(adam[key], jax.tree.leaves(ref.opt_state[1][key]),
                                       strict=True)):
            _close(g, r, REL, f"{what} {key} {i}")
    lr_sum = sum(float(SCHEDULE(TO)(i)) for i in range(state.step))
    for i, (g, r) in enumerate(zip(tree_leaves(state.params), jax.tree.leaves(ref.params),
                                   strict=True)):
        r = np.asarray(r)
        err = float(np.abs(g.detach().numpy() - r).max())
        assert err <= REL * float(np.abs(r).max()) + 1e-3 * lr_sum, f"{what} param {i}: {err:.3e}"


# arctic at 1 microbatch: one expert takes no token in step 2 and a gradient
# 2e-7 of its leaf's largest in step 1, so AdamW's move there is set by
# rounding (1.2e-3 of Σ lr, past the 1e-3 the rule above allows); its
# 2-microbatch run and its loss-and-gradient case hold it to the reference
THREE_STEP_CASES = [(m, a) for m in (1, 2)
                    for a in ("tinyllama_1b", "mamba2_370m", "minicpm3_4b", "qwen2_moe_a2_7b",
                              "arctic_480b", "olmo_1b", "gemma_2b", "phi3_vision_4b",
                              "whisper_medium")
                    if (m, a) != (1, "arctic_480b")]


@pytest.mark.parametrize("microbatches,arch", THREE_STEP_CASES)
def test_train_step_matches_jax_over_three_steps(arch, microbatches):
    cfg = get_reduced_config(arch).replace(dtype="float32")
    batches, states, metrics = _jax_run(arch, microbatches)
    tm = model_from_jax(cfg, _np(states[0].params), device="cpu", train=True)
    opt = _opt(TO)
    state = init_train_state(tm.param_tree(), opt)
    step = make_train_step(tm, opt, microbatches=microbatches)
    for i, b in enumerate(batches):
        state, m = step(state, b)
        assert m["step"] == i
        _close(m["loss"], metrics[i]["loss"], REL, f"loss {i}")
        _close(m["grad_norm"], metrics[i]["grad_norm"], REL, f"grad_norm {i}")
    _check_state(state, states[-1], "after 3 steps")


@pytest.mark.parametrize("arch", ["tinyllama_1b", "mamba2_370m"])
def test_one_step_from_a_carried_reference_state(arch):
    cfg = get_reduced_config(arch).replace(dtype="float32")
    batches, states, metrics = _jax_run(arch, 1)
    tm, state = train_state_from_jax(cfg, _np(states[2]), _opt(TO), device="cpu")
    _check_state(state, states[2], "carried")
    assert [p for p in tm.parameters()] and all(p.requires_grad for p in tm.parameters())
    state, m = make_train_step(tm, _opt(TO))(state, batches[2])
    _close(m["loss"], metrics[2]["loss"], REL, "loss")
    _check_state(state, states[3], "one step on")


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_moe_expert_stacks_carry_their_moments(name):
    """A reference state one step in, carried onto qwen2-moe's 4-D expert
    leaves (adafactor's row and column moments (L, E, d) and (L, E, f)),
    then one more step in each package: the same loss and params."""
    make = {"adamw": lambda M: M.adamw(1e-2), "adafactor": lambda M: M.adafactor(1e-2)}[name]
    cfg = get_reduced_config("qwen2_moe_a2_7b").replace(dtype="float32")
    jm = jax_build(jax_config("qwen2_moe_a2_7b").replace(dtype="float32"))
    params, _ = jm.init(jax.random.PRNGKey(2))
    step = jax.jit(jax_train_step(jm, make(RO)))
    batches = _batches(jm.cfg, 2, seed=3)
    state, _ = step(jax_init_state(params, make(RO)),
                    {k: jnp.asarray(v) for k, v in batches[0].items()})
    tm, tstate = train_state_from_jax(cfg, _np(state), make(TO), device="cpu")
    L, E, d, f = tm.stack["moe"]["wi_gate"].shape
    moments = tree_leaves(tstate.opt_state)
    want = [(L, E, d), (L, E, f)] if name == "adafactor" else [(L, E, d, f)]
    assert all(any(tuple(m.shape) == w for m in moments) for w in want)
    state, m = step(state, {k: jnp.asarray(v) for k, v in batches[1].items()})
    tstate, tmet = make_train_step(tm, make(TO))(tstate, batches[1])
    _close(tmet["loss"], m["loss"], REL, "loss")
    for i, (g, r) in enumerate(zip(tree_leaves(tstate.params), jax.tree.leaves(state.params),
                                   strict=True)):
        r = np.asarray(r)
        err = float(np.abs(g.detach().numpy() - r).max())
        assert err <= REL * float(np.abs(r).max()) + 1e-3 * 2e-2, f"param {i}: {err:.3e}"
