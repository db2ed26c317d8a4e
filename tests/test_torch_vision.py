"""The port's vision prefix (reduced phi-3-vision: stub patch embeddings
prepended to the text) against the JAX package's on the same weights
(``model_from_jax``): the loss with and without ``patch_embeds`` (the
prefix's positions dropped from the CE), its gradients, and a prefill of
the prefix and the prompt with its cache, then decode steps on tokens only.

Tolerances, relative to each tensor's largest magnitude, as
``tests/test_torch_lm.py``: f32 1e-5, bf16 4e-2.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401
from torch_train_cases import _batch, check_loss_and_grads  # noqa: E402

from repro.configs import get_reduced_config as jax_config  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.models import model_from_jax  # noqa: E402

REL = {"float32": 1e-5, "bfloat16": 4e-2}
NAME = "phi3_vision_4b"


def _close(got, ref, rel, what):
    ref = np.asarray(ref, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == ref.shape, what
    err = float(np.abs(got - ref).max())
    assert err <= rel * float(np.abs(ref).max()), f"{what}: max err {err:.3e}"


def _pair(dtype, train=False, seed=0):
    jm = jax_build(jax_config(NAME).replace(dtype=dtype))
    params, _ = jm.init(jax.random.PRNGKey(seed))
    tm = model_from_jax(get_reduced_config(NAME).replace(dtype=dtype),
                        jax.tree.map(np.asarray, params), device="cpu", train=train)
    return jm, params, tm


@pytest.mark.parametrize("prefix", [True, False], ids=["with-patches", "text-only"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_with_and_without_the_prefix_matches_jax(prefix, dtype):
    jm, params, tm = _pair(dtype, train=True)
    batch = _batch(tm.cfg, 2, 12, 3)
    assert batch["patch_embeds"].shape == (2, tm.cfg.n_modality_positions, tm.cfg.d_model)
    if not prefix:
        del batch["patch_embeds"]
    jloss, jmet = jax.jit(jm.loss_fn)(params, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        loss, met = tm.loss_fn(batch)
    _close(loss, jloss, REL[dtype], "loss")
    _close(met["ce"], jmet["ce"], REL[dtype], "ce")
    if prefix and dtype == "float32":
        # the prefix moves the text's hidden states, so the loss (at random
        # init by less than bf16's tolerance)
        with torch.no_grad():
            text_only, _ = tm.loss_fn({k: v for k, v in batch.items() if k != "patch_embeds"})
        assert abs(float(text_only) - float(loss)) > REL[dtype] * abs(float(loss))


@pytest.mark.parametrize("dtype,opts", [("float32", {}), ("float32", {"remat": "dots"}),
                                        ("bfloat16", {})])
def test_gradients_through_the_prefix_match_jax(dtype, opts):
    check_loss_and_grads(NAME, dtype, {}, opts, 10, False)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_with_the_prefix_and_decode_match_jax(dtype):
    jm, params, tm = _pair(dtype, seed=1)
    rel = REL[dtype]
    cfg = tm.cfg
    P = cfg.n_modality_positions
    batch = _batch(cfg, 2, 9, 4)
    pre = {"tokens": batch["tokens"], "patch_embeds": batch["patch_embeds"]}
    jcache, _ = jm.init_cache(2, 32)
    tcache = tm.init_cache(2, 32)
    jl, jcache = jax.jit(jm.prefill)(params, {k: jnp.asarray(v) for k, v in pre.items()}, jcache)
    tl, tcache = tm.prefill(pre, tcache)
    _close(tl, jl, rel, "prefill logits")
    for key in ("k", "v"):
        _close(tcache[key], jcache[key], rel, f"cache {key}")
    assert int(tcache["pos"]) == int(jcache["pos"]) == P + 9
    decode = jax.jit(jm.decode_step)
    rng = np.random.default_rng(4)
    for step in range(4):
        nxt = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        jl, jcache = decode(params, jnp.asarray(nxt), jcache)
        tl, tcache = tm.decode_step(nxt, tcache)
        _close(tl, jl, rel, f"decode step {step} logits")
    assert int(tcache["pos"]) == P + 13
