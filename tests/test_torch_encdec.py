"""The port's encoder-decoder (reduced whisper-medium) against the JAX
package's on the same weights (``model_from_jax``): ``sinusoid_pos`` bit for
bit, ``cross_kv`` and ``cross_attention_apply``, the encoder's
bidirectional rope-free attention through both of its routes (``_sdpa``
when an input requires grad, the flash-attention kernel's route, here its
plain version, when none does), ``loss_fn`` and its gradients, a prefill
(frames and 6 prompt tokens) with its cross caches and 4 decode steps, the
reference smoke test's prefill/decode consistency, and the ``ValueError``
where the reference clamps past ``dec_max_len``.

Tolerances, relative to each tensor's largest magnitude, as
``tests/test_torch_lm.py``: f32 1e-5, bf16 4e-2 (the frameworks round to
bf16 at other places, and the kernel's plain version keeps the encoder's
attention weights in f32 where the reference rounds them to bf16).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401
from torch_train_cases import check_loss_and_grads  # noqa: E402

from repro.configs import get_reduced_config as jax_config  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import encdec as RE  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.models import EncDecModel, model_from_jax  # noqa: E402
from repro_torch.models import encdec as TE  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

REL = {"float32": 1e-5, "bfloat16": 4e-2}
NAME = "whisper_medium"


def _close(got, ref, rel, what):
    ref = np.asarray(ref, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == ref.shape, what
    err = float(np.abs(got - ref).max())
    assert err <= rel * float(np.abs(ref).max()), f"{what}: max err {err:.3e}"


def _pair(dtype, seed=0):
    """(JAX model, its params, the port's serving model on the same weights)."""
    jm = jax_build(jax_config(NAME).replace(dtype=dtype))
    params, _ = jm.init(jax.random.PRNGKey(seed))
    tm = model_from_jax(get_reduced_config(NAME).replace(dtype=dtype),
                        jax.tree.map(np.asarray, params), device="cpu")
    return jm, params, tm


def _frames(cfg, B, T, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, cfg.d_model)) * 0.02).astype(np.float32)


@pytest.mark.parametrize("T,D", [(1, 64), (12, 64), (40, 16), (1500, 1024)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sinusoid_pos_is_the_reference_bit_for_bit(T, D, dtype):
    ref = np.asarray(RE.sinusoid_pos(T, D, getattr(jnp, dtype)).astype(jnp.float32))
    got = TE.sinusoid_pos(T, D, getattr(torch, dtype)).float().numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_kv_and_cross_attention_match_jax(dtype):
    cfg = jax_config(NAME).replace(dtype=dtype)
    p = jax.tree.map(np.asarray, RE.init_cross_attention(jax.random.PRNGKey(5), cfg)[0])
    tp = {k: torch.tensor(v) for k, v in p.items()}
    rng = np.random.default_rng(5)
    memory = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    x = rng.standard_normal((2, 4, cfg.d_model)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jk, jv = RE.cross_kv(p, jnp.asarray(memory, jd))
    tk, tv = TE.cross_kv(tp, torch.tensor(memory).to(td))
    _close(tk, jk, REL[dtype], "cross k")
    _close(tv, jv, REL[dtype], "cross v")
    ref = RE.cross_attention_apply(p, jnp.asarray(x, jd), jk, jv, cfg)
    got = TE.cross_attention_apply(tp, torch.tensor(x).to(td), tk, tv, cfg)
    _close(got, ref, REL[dtype], "cross attention")


@pytest.mark.parametrize("grad", [True, False], ids=["grad-sdpa", "no-grad-kernel"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_attention_matches_jax_on_both_routes(grad, dtype, monkeypatch):
    """Bidirectional rope-free attention, no cache: with inputs that
    require grad it attends through ``_sdpa`` (the wrapper is never
    called); with none it calls the flash-attention wrapper with
    ``causal=False`` (on the CPU, its plain version)."""
    from repro_torch.kernels.flash_attention import ops as fa

    cfg = jax_config(NAME).replace(dtype=dtype)
    p = jax.tree.map(np.asarray, RL.init_attention(jax.random.PRNGKey(6), cfg)[0])
    x = _frames(cfg, 2, 11, 6)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref, _ = RL.attention_apply(p, jnp.asarray(x, jd), cfg, positions=jnp.arange(11),
                                bidirectional=True, use_rope=False)
    calls = []
    monkeypatch.setattr(TL, "flash_attention",
                        lambda *a, **kw: calls.append(kw) or fa.flash_attention(*a, **kw))
    tp = {k: torch.tensor(v, requires_grad=grad) for k, v in p.items()}
    got, cache = TL.attention_apply(tp, torch.tensor(x).to(td), cfg, positions=torch.arange(11),
                                    bidirectional=True, use_rope=False)
    assert cache is None
    _close(got, ref, REL[dtype], "encoder attention")
    assert calls == ([] if grad else [{"causal": False}])
    if grad:
        got.float().sum().backward()
        assert all(torch.isfinite(t.grad).all() for t in tp.values())


@pytest.mark.parametrize("dtype,opts", [("float32", {}), ("bfloat16", {"remat": "full"})])
def test_loss_and_grads_match_jax(dtype, opts):
    check_loss_and_grads(NAME, dtype, {}, opts, 10, True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_cross_caches_and_decode_match_jax(dtype):
    jm, params, tm = _pair(dtype)
    assert isinstance(tm, EncDecModel)
    rel = REL[dtype]
    cfg = tm.cfg
    rng = np.random.default_rng(7)
    frames = _frames(cfg, 2, 20, 7)
    tokens = rng.integers(0, cfg.vocab_size, (2, 6)).astype(np.int32)
    jcache, _ = jm.init_cache(2, 20)
    tcache = tm.init_cache(2, 20)
    prefill, decode = jax.jit(jm.prefill), jax.jit(jm.decode_step)
    batch = {"frames": frames, "tokens": tokens}
    jl, jcache = prefill(params, {k: jnp.asarray(v) for k, v in batch.items()}, jcache)
    tl, tcache = tm.prefill(batch, tcache)
    _close(tl, jl, rel, "prefill logits")
    for key in ("cross_k", "cross_v"):
        assert tcache[key].shape == (cfg.n_dec_layers, 2, 20, cfg.n_kv_heads, cfg.head_dim)
        _close(tcache[key], jcache[key], rel, key)
    for key in ("k", "v"):
        _close(tcache["self"][key], jcache["self"][key], rel, f"self {key}")
    assert int(tcache["pos"]) == int(jcache["pos"]) == 6
    for step in range(4):
        nxt = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        jl, jcache = decode(params, jnp.asarray(nxt), jcache)
        tl, tcache = tm.decode_step(nxt, tcache)
        _close(tl, jl, rel, f"decode step {step} logits")
    assert int(tcache["pos"]) == 10


def test_prefill_decode_consistency_as_the_reference_smoke_test():
    """``tests/test_models_smoke.py``'s check: the last logits of a 6-token
    prefill equal those of a 5-token prefill and one decode step (atol and
    rtol 2e-2, bf16), in the port, and each against the reference's."""
    jm, params, tm = _pair("bfloat16", seed=1)
    cfg = tm.cfg
    rng = np.random.default_rng(1)
    frames = _frames(cfg, 2, 12, 1)
    tokens = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    logits_a, _ = tm.prefill({"frames": frames, "tokens": tokens[:, :6]}, tm.init_cache(2, 12))
    _, cache_b = tm.prefill({"frames": frames, "tokens": tokens[:, :5]}, tm.init_cache(2, 12))
    logits_b, _ = tm.decode_step(tokens[:, 5:6], cache_b)
    a, b = logits_a[:, -1].float().numpy(), logits_b[:, -1].float().numpy()
    np.testing.assert_allclose(a, b, atol=2e-2, rtol=2e-2)
    jl, _ = jm.prefill(params, {"frames": jnp.asarray(frames), "tokens": jnp.asarray(tokens[:, :6])},
                       jm.init_cache(2, 12)[0])
    _close(logits_a[:, -1], np.asarray(jl, np.float32)[:, -1], REL["bfloat16"], "vs reference")


def test_decoder_raises_past_dec_max_len():
    """The reference clamps a write and a position slice past dec_max_len
    (32 in the reduced config); the port raises."""
    _, _, tm = _pair("float32")
    L = tm.cfg.dec_max_len
    frames = _frames(tm.cfg, 1, 8, 2)
    with pytest.raises(ValueError, match="dec_max_len"):
        tm.prefill({"frames": frames, "tokens": np.zeros((1, L + 1), np.int32)},
                   tm.init_cache(1, 8))
    _, cache = tm.prefill({"frames": frames, "tokens": np.zeros((1, L - 1), np.int32)},
                          tm.init_cache(1, 8))
    _, cache = tm.decode_step(np.zeros((1, 1), np.int32), cache)
    assert int(cache["pos"]) == L
    with pytest.raises(ValueError, match="dec_max_len"):
        tm.decode_step(np.zeros((1, 1), np.int32), cache)
