"""The port's decoder LMs against the JAX package's ``Model`` on the same
weights: reduced tinyllama (dense GQA), olmo-1b (non-parametric LayerNorm),
gemma-2b (GeGLU, MQA, scaled embeddings), mamba2 (SSM), minicpm3 (MLA),
qwen2-moe and arctic (MoE), the JAX params carried across by
``model_from_jax``. Prefill logits, the cache after the
prefill and four decode steps are compared; and a soft-capped gemma over a
prefill from empty, a chunked prefill and decode, which never reaches the
flash-attention kernel (it has no softcap).

Tolerances, relative to each tensor's largest magnitude: f32 1e-5 (the same
arithmetic with sums in another order; observed ≤ 2e-6); bf16 4e-2, about
ten bf16 ulps (2^-8): the frameworks round to bf16 at other places, and the
port keeps the attention weights of the prefill and the SSD scan's scores
in f32 where the reference rounds them to bf16 (observed ≤ 2e-2).
"""
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_reduced_config as jax_config  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.models import model_from_jax  # noqa: E402

REL = {"float32": 1e-5, "bfloat16": 4e-2}


def pair(name, dtype, seed=0):
    """(JAX model, its params, the port's model on the same weights)."""
    jm = jax_build(jax_config(name).replace(dtype=dtype))
    params, _ = jm.init(jax.random.PRNGKey(seed))
    np_params = jax.tree.map(np.asarray, params)
    return jm, params, model_from_jax(get_reduced_config(name).replace(dtype=dtype), np_params,
                                      device="cpu")


def _close(got, ref, rel, what):
    ref = np.asarray(ref, np.float32)
    got = got.float().numpy()
    assert got.shape == ref.shape, what
    err = float(np.abs(got - ref).max())
    assert err <= rel * float(np.abs(ref).max()), f"{what}: max err {err:.3e}"


@pytest.mark.parametrize("name", ["tinyllama_1b", "mamba2_370m", "minicpm3_4b",
                                  "qwen2_moe_a2_7b", "arctic_480b", "olmo_1b", "gemma_2b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [12, 32])
def test_prefill_cache_and_decode_match_jax(name, dtype, T):
    jm, params, tm = pair(name, dtype)
    rel = REL[dtype]
    rng = np.random.default_rng(T)
    tokens = rng.integers(0, jm.cfg.vocab_size, (2, T)).astype(np.int32)
    jcache, _ = jm.init_cache(2, 48)
    tcache = tm.init_cache(2, 48)
    jl, jcache = jm.prefill(params, {"tokens": jnp.asarray(tokens)}, jcache)
    tl, tcache = tm.prefill({"tokens": tokens}, tcache)
    _close(tl, jl, rel, "prefill logits")
    for key in jcache:
        if key != "pos":
            _close(tcache[key], jcache[key], rel, f"cache {key}")
    assert int(tcache["pos"]) == int(jcache["pos"]) == T
    for step in range(4):
        nxt = rng.integers(0, jm.cfg.vocab_size, (2, 1)).astype(np.int32)
        jl, jcache = jm.decode_step(params, jnp.asarray(nxt), jcache)
        tl, tcache = tm.decode_step(nxt, tcache)
        _close(tl, jl, rel, f"decode step {step} logits")
    assert int(tcache["pos"]) == T + 4


def test_weights_are_stored_in_the_activation_dtype():
    _, _, tm = pair("mamba2_370m", "bfloat16")
    ssd = tm.layers[0].ssd
    assert tm.emb["embed"].dtype == ssd["in_proj"].dtype == ssd["D"].dtype == torch.bfloat16
    assert ssd["A_log"].dtype == ssd["dt_bias"].dtype == tm.layers[0].ln["scale"].dtype == (
        torch.float32)


# small enough to bite at the reduced widths, whose attention scores are
# O(1): a cap of 30 moves the logits by 0.8% of max, inside bf16's tolerance
SOFTCAP = 2.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softcapped_gemma_matches_jax_without_the_kernel(dtype, monkeypatch):
    """gemma-2b reduced with ``logits_softcap`` SOFTCAP: a prefill from empty (the
    kernel's route without a softcap), a chunked prefill of 5 more tokens
    and four decode steps against the reference's; the kernel's wrapper is
    never called, and its launch counter does not move. The control: the
    same prefill without the softcap calls it once a layer, and its logits
    lie further from the soft-capped ones than twice the tolerance."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models import layers as TL

    name = "gemma_2b"
    jm = jax_build(jax_config(name).replace(dtype=dtype, logits_softcap=SOFTCAP))
    params, _ = jm.init(jax.random.PRNGKey(3))
    np_params = jax.tree.map(np.asarray, params)
    cfg = get_reduced_config(name).replace(dtype=dtype, logits_softcap=SOFTCAP)
    tm = model_from_jax(cfg, np_params, device="cpu")
    calls = []
    monkeypatch.setattr(TL, "flash_attention",
                        lambda *a, **kw: calls.append(kw) or fa.flash_attention(*a, **kw))
    rel = REL[dtype]
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    before = fa.LAUNCHES
    jcache, _ = jm.init_cache(2, 48)
    tcache = tm.init_cache(2, 48)
    jl, jcache = jm.prefill(params, {"tokens": jnp.asarray(tokens[:, :11])}, jcache)
    tl, tcache = tm.prefill({"tokens": tokens[:, :11]}, tcache)
    _close(tl, jl, rel, "prefill from empty")
    jl, jcache = jm.prefill(params, {"tokens": jnp.asarray(tokens[:, 11:])}, jcache)
    tl, tcache = tm.prefill({"tokens": tokens[:, 11:]}, tcache)
    _close(tl, jl, rel, "chunked prefill")
    for key in ("k", "v"):
        _close(tcache[key], jcache[key], rel, f"cache {key}")
    for step in range(4):
        nxt = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        jl, jcache = jm.decode_step(params, jnp.asarray(nxt), jcache)
        tl, tcache = tm.decode_step(nxt, tcache)
        _close(tl, jl, rel, f"decode step {step} logits")
    assert calls == [] and fa.LAUNCHES == before
    capped, _ = tm.prefill({"tokens": tokens[:, :11]}, tm.init_cache(2, 48))
    plain = model_from_jax(cfg.replace(logits_softcap=0.0), np_params, device="cpu")
    free, _ = plain.prefill({"tokens": tokens[:, :11]}, plain.init_cache(2, 48))
    assert len(calls) == cfg.n_layers
    gap = float((free.float() - capped.float()).abs().max())
    assert gap > 2 * rel * float(capped.float().abs().max()), gap
