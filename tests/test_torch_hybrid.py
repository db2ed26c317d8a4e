"""The port's hybrid family (reduced recurrentgemma: one (rec, rec, attn)
group and a two-block rec tail, local attention over a window of 16)
against the JAX package's on the same weights, carried across by
``model_from_jax``:

- prefill at T below, at and above the window (the last through
  ``local_attention_chunked`` and the ring's roll), into a ring cache
  (``max_len`` 48 > window) and into a linear one (``max_len`` 12 < window),
  the nested cache leaf by leaf, then decode steps past the ring's wrap.
  Each decode step starts from the reference's cache of the step before:
  the conv tail is stored in bf16 in both packages, so a difference of an
  f32 ulp upstream can round one of its values to the neighbouring bf16
  value, and the recurrence carries that on (free-running f32 logits
  drifted to 3e-5 of max over 20 steps); a step from one state holds the
  f32 rule;
- the ``ServeEngine`` against the JAX engine with per-slot positions
  (greedy tokens equal at f32), prompts below and above the window;
- the training forward at f32: loss and every gradient leaf
  (``torch_train_cases``), T below and above the window, remat per group.
  Not at bf16: there the reference's own gradients of the recurrent blocks
  lie up to 4.4% of max off its f32 gradients and the port's up to 5.5%,
  7.3% from each other (measured at T 12): rounding, past the 4e-2 rule;
- a reference ``TrainState`` one AdamW step in, carried across by
  ``train_state_from_jax``, then three steps in each package: the losses
  and grad norms of each, the moments after the first, the params after
  the third. AdamW moves a weight by about lr whatever the size of its
  gradient, so the params part by up to 1e-3 of Σ lr, and the moments of
  later steps by more than the f32 rule (measured 2.2e-5 of max after the
  third).

Tolerances, relative to each tensor's largest magnitude, as
``tests/test_torch_lm.py``: f32 1e-5, bf16 4e-2; a bf16 cache leaf (the
conv tail) within one bf16 ulp (2^-8) of its largest magnitude. The train
steps' params as ``tests/test_torch_train_step.py``: 1e-5 of their largest
magnitude plus 1e-3 of the summed learning rates."""
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch_train_cases import check_loss_and_grads  # noqa: E402

from repro import optim as RO  # noqa: E402
from repro.configs import get_reduced_config as jax_config  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.serve import GenerationConfig as JGen  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro.train import init_train_state as jax_init_state  # noqa: E402
from repro.train import make_train_step as jax_train_step  # noqa: E402
from repro_torch import optim as TO  # noqa: E402
from repro_torch.configs import get_config, get_reduced_config  # noqa: E402
from repro_torch.models import build_model, model_from_jax  # noqa: E402
from repro_torch.models.convert import train_state_from_jax  # noqa: E402
from repro_torch.serve import GenerationConfig, Request, ServeEngine  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402
from repro_torch.train.state import tree_leaves  # noqa: E402

ARCH = "recurrentgemma_2b"
REL = {"float32": 1e-5, "bfloat16": 4e-2}
BF16_ULP = 2.0 ** -8


def _pair(dtype, seed=0):
    jm = jax_build(jax_config(ARCH).replace(dtype=dtype))
    params, _ = jm.init(jax.random.PRNGKey(seed))
    tm = model_from_jax(get_reduced_config(ARCH).replace(dtype=dtype),
                        jax.tree.map(np.asarray, params), device="cpu")
    return jm, params, tm


def _close(got, ref, rel, what):
    ref = np.asarray(ref, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == ref.shape, what
    err = float(np.abs(got - ref).max())
    assert err <= rel * max(float(np.abs(ref).max()), 1e-30), f"{what}: max err {err:.3e}"


def _leaves(cache):
    """(key path, leaf) of a nested cache, 'pos' left out."""
    out = []
    for k in sorted(cache):
        if isinstance(cache[k], dict):
            out += [((k,) + p, v) for p, v in _leaves(cache[k])]
        elif k != "pos":
            out.append(((k,), cache[k]))
    return out


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _check_cache(tcache, jcache, rel, what):
    tl = _leaves(tcache)
    assert [p for p, _ in tl] == [p for p, _ in _leaves(jcache)], what
    for path, leaf in tl:
        ref = _at(jcache, path)
        assert leaf.dtype == getattr(torch, str(ref.dtype)), (what, path)
        _close(leaf, ref, max(rel, BF16_ULP) if leaf.dtype == torch.bfloat16 else rel,
               f"{what} {'/'.join(path)}")
    assert int(tcache["pos"]) == int(jcache["pos"]), what


def _load(tcache, jcache):
    """The reference's cache values into the port's buffers (in place)."""
    for path, leaf in _leaves(tcache):
        leaf.copy_(torch.tensor(np.asarray(_at(jcache, path), np.float32)))
    tcache["pos"] = torch.tensor(int(jcache["pos"]), dtype=torch.int32)
    return tcache


CACHE_CASES = [(7, 48), (16, 48), (23, 48), (7, 12)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,max_len", CACHE_CASES, ids=[f"T{t}-len{m}" for t, m in CACHE_CASES])
def test_prefill_cache_and_decode_match_jax(dtype, T, max_len):
    jm, params, tm = _pair(dtype)
    rel = REL[dtype]
    rng = np.random.default_rng(T)
    tokens = rng.integers(0, jm.cfg.vocab_size, (2, T)).astype(np.int32)
    jcache, _ = jm.init_cache(2, max_len)
    tcache = tm.init_cache(2, max_len)
    ring = max_len > jm.cfg.attn_window
    assert tcache["groups"]["b2"]["k"].shape[2] == (jm.cfg.attn_window if ring else max_len)
    jl, jcache = jax.jit(jm.prefill)(params, {"tokens": jnp.asarray(tokens)}, jcache)
    tl, tcache = tm.prefill({"tokens": tokens}, tcache)
    _close(tl, jl, rel, "prefill logits")
    _check_cache(tcache, jcache, rel, "prefill cache")
    steps = min(12, max_len - T)
    decode = jax.jit(jm.decode_step)
    for step in range(steps):
        nxt = rng.integers(0, jm.cfg.vocab_size, (2, 1)).astype(np.int32)
        tcache = _load(tcache, jcache)
        jl, jcache = decode(params, jnp.asarray(nxt), jcache)
        tl, tcache = tm.decode_step(nxt, tcache)
        _close(tl, jl, rel, f"decode step {step} logits")
        _check_cache(tcache, jcache, rel, f"decode step {step} cache")
    if ring:
        assert T + steps > jm.cfg.attn_window  # the ring wrapped


def test_engine_matches_jax_engine():
    jm, params, tm = _pair("float32", seed=1)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, jm.cfg.vocab_size, n).astype(np.int32) for n in (5, 16, 9, 23, 7)]
    jeng = JServeEngine(jm, params, n_slots=2, max_len=64)
    jeng.cache["pos"] = jnp.zeros((2,), jnp.int32)
    teng = ServeEngine(tm, n_slots=2, max_len=64, device="cpu")
    teng.cache["pos"] = torch.zeros(2, dtype=torch.int32)
    for i, p in enumerate(prompts):
        gen = dict(max_new_tokens=3 + 3 * i)
        jeng.submit(JRequest(uid=i, prompt=p, gen=JGen(**gen)))
        teng.submit(Request(uid=i, prompt=p, gen=GenerationConfig(**gen)))
    jdone = {r.uid: r.output for r in jeng.run_until_drained()}
    tdone = {r.uid: r.output for r in teng.run_until_drained()}
    assert tdone == jdone
    assert teng.ticks == jeng.ticks


LOSS_CASES = [
    # (dtype, build options, T, uniform weights): T 12 inside the window of
    # 16, T 24 past it (local_attention_chunked), remat per group
    ("float32", {}, 12, False),
    ("float32", {"remat": "full"}, 24, False),
    ("float32", {"remat": "dots"}, 12, True),
]


@pytest.mark.parametrize("dtype,opts,T,uniform", LOSS_CASES,
                         ids=[f"{d}-{o}-T{t}" for d, o, t, _ in LOSS_CASES])
def test_loss_and_grads_match_jax(dtype, opts, T, uniform):
    check_loss_and_grads(ARCH, dtype, {}, opts, T, uniform)


def _schedule(M):
    return M.cosine_warmup(1e-2, 2, 6)


def _opt(M):
    return M.chain(M.clip_by_global_norm(1.0), M.adamw(_schedule(M)))


def test_three_steps_from_a_carried_reference_state():
    jm = jax_build(jax_config(ARCH).replace(dtype="float32"))
    params, _ = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    batches = []
    for _ in range(4):
        toks = rng.integers(0, jm.cfg.vocab_size, (4, 17)).astype(np.int32)
        batches.append({"tokens": toks[:, :-1], "labels": toks[:, 1:],
                        "weights": rng.uniform(0.2, 3.0, 4).astype(np.float32)})
    step = jax.jit(jax_train_step(jm, _opt(RO)))
    state, _ = step(jax_init_state(params, _opt(RO)),
                    {k: jnp.asarray(v) for k, v in batches[0].items()})
    tm, tstate = train_state_from_jax(get_reduced_config(ARCH).replace(dtype="float32"),
                                      jax.tree.map(np.asarray, state), _opt(TO), device="cpu")
    assert sorted(tm.param_tree()) == ["emb", "groups", "ln_f", "tail"]
    tstep = make_train_step(tm, _opt(TO))
    for i, b in enumerate(batches[1:]):
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tm_ = tstep(tstate, b)
        assert tm_["step"] == i + 1
        _close(tm_["loss"], m["loss"], REL["float32"], f"loss {i}")
        _close(tm_["grad_norm"], m["grad_norm"], REL["float32"], f"grad_norm {i}")
        if i == 0:  # the moments one step from the carried state
            adam = tstate.opt_state[1]
            for key in ("m", "v"):
                for j, (g, r) in enumerate(zip(adam[key],
                                               jax.tree.leaves(state.opt_state[1][key]),
                                               strict=True)):
                    _close(g, r, REL["float32"], f"{key} {j}")
    lr_sum = sum(float(_schedule(TO)(i)) for i in range(tstate.step))
    for i, (g, r) in enumerate(zip(tree_leaves(tstate.params), jax.tree.leaves(state.params),
                                   strict=True)):
        r = np.asarray(r)
        err = float(np.abs(g.detach().numpy() - r).max())
        assert err <= REL["float32"] * float(np.abs(r).max()) + 1e-3 * lr_sum, f"param {i}"


def test_published_config_and_cache_layout():
    """recurrentgemma-2b's published numbers, and the reduced model's nested
    cache: group leaves stacked (n_groups, B, ...), tail leaves (B, ...),
    the attn block's cache min(window, max_len) long."""
    cfg = get_config(ARCH)
    assert (cfg.family, cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.lru_width, cfg.attn_window) == ("hybrid", 26, 2560, 10, 1, 256, 2560, 2048)
    model = build_model(get_reduced_config(ARCH), device="cpu", seed=0)
    cache = model.init_cache(3, 40)
    assert sorted(cache) == ["groups", "pos", "tail"]
    assert sorted(cache["groups"]) == ["b0", "b1", "b2"] and sorted(cache["tail"]) == ["b0", "b1"]
    assert cache["groups"]["b0"]["conv"].shape == (1, 3, 3, 64)
    assert cache["groups"]["b0"]["conv"].dtype == torch.bfloat16
    assert cache["groups"]["b2"]["k"].shape == (1, 3, 16, 1, 16)
    assert cache["tail"]["b1"]["h"].shape == (3, 64) and cache["tail"]["b1"]["h"].dtype == (
        torch.float32)
