"""The port's mamba2 training forward against the JAX package's (the loss
and every leaf's gradient, as ``test_torch_train_loss.py`` holds the dense
family, through the SSD scan's plain version with weights cast at use),
and chunked prefill on both families: 12 tokens, then 8 more, into one
cache, the second prefill attending the cache up to each query (dense)
or carrying the SSD state (mamba2); the logits and the cache after each.
Where a chunk's decay overflows f32 (large steps dt), the reference's
gradient is NaN (``where`` after the exp); the port's scan masks first, so
its loss is the reference's and its gradients are finite and equal to
those through the one-step recurrence.

Tolerances, relative to each tensor's largest magnitude, as
``tests/test_torch_lm.py``: f32 1e-5; bf16 4e-2."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch_train_cases import REL, _close, check_loss_and_grads, one_thread  # noqa: E402,F401

from repro.configs import get_reduced_config as jax_config  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.models import model_from_jax  # noqa: E402

CASES = [
    # (dtype, build options, T, uniform weights)
    ("float32", {}, 32, False),
    ("bfloat16", {}, 32, False),
    ("float32", {"remat": "full", "xent_chunk": 8}, 16, True),
]


@pytest.mark.parametrize("dtype,opts,T,uniform", CASES,
                         ids=[f"{d}-{o}-T{t}" for d, o, t, _ in CASES])
def test_ssm_loss_and_grads_match_jax(dtype, opts, T, uniform):
    check_loss_and_grads("mamba2_370m", dtype, {}, opts, T, uniform)


@pytest.mark.parametrize("arch", ["tinyllama_1b", "mamba2_370m"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_prefill_matches_jax(arch, dtype):
    """12 tokens, then 8 more, into one cache: the second prefill attends
    the cache up to each query (dense) or carries the SSD state (mamba2)."""
    rel = REL[dtype]
    jm = jax_build(jax_config(arch).replace(dtype=dtype))
    params, _ = jm.init(jax.random.PRNGKey(1))
    tm = model_from_jax(get_reduced_config(arch).replace(dtype=dtype),
                        jax.tree.map(np.asarray, params), device="cpu")
    toks = np.random.default_rng(2).integers(0, jm.cfg.vocab_size, (2, 20)).astype(np.int32)
    jcache, _ = jm.init_cache(2, 32)
    tcache = tm.init_cache(2, 32)
    prefill = jax.jit(jm.prefill)
    for sl in (slice(0, 12), slice(12, 20)):
        jl, jcache = prefill(params, {"tokens": jnp.asarray(toks[:, sl])}, jcache)
        tl, tcache = tm.prefill({"tokens": toks[:, sl]}, tcache)
        _close(tl, jl, rel, f"logits after {sl}")
        for key in jcache:
            if key != "pos":
                _close(tcache[key], jcache[key], rel, f"cache {key} after {sl}")
    assert int(tcache["pos"]) == int(jcache["pos"]) == 20


def _recurrent_scan(x, dt, A, Bm, Cm, state0=None, *, chunk):
    """The SSD scan one step at a time (the decode step's recurrence)."""
    Bt, T, H, P = x.shape
    state = x.new_zeros((Bt, H, P, Bm.shape[-1]), dtype=torch.float32)
    ys = []
    for t in range(T):
        a = torch.exp(dt[:, t] * A)
        upd = torch.einsum("bn,bhp,bh->bhpn", Bm[:, t, 0].float(), x[:, t].float(), dt[:, t])
        state = state * a[:, :, None, None] + upd
        ys.append(torch.einsum("bn,bhpn->bhp", Cm[:, t, 0].float(), state))
    return torch.stack(ys, 1).to(x.dtype), state


def test_ssd_gradients_stay_finite_where_the_decay_overflows(monkeypatch):
    from repro_torch.models import ssm as TSSM
    from repro_torch.train.trainer import loss_and_grads

    jm = jax_build(jax_config("mamba2_370m").replace(dtype="float32"))
    params, _ = jm.init(jax.random.PRNGKey(0))
    # dt ≈ 0.44: 16 steps at |A| = 16 decay by e^-113, past f32's e^88 (the
    # smallest such shift; at dt ≈ 8 the chunked form's cumulative
    # log-decays, the reference's too, lose f32 precision: 1.4e-5 apart)
    params["layers"]["ssd"]["dt_bias"] = params["layers"]["ssd"]["dt_bias"] + 4.0
    toks = np.random.default_rng(0).integers(0, jm.cfg.vocab_size, (2, 33)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(params, jbatch)
    assert not all(bool(jnp.isfinite(g).all()) for g in jax.tree.leaves(jgrads))
    cfg = get_reduced_config("mamba2_370m").replace(dtype="float32")
    tm = model_from_jax(cfg, jax.tree.map(np.asarray, params), device="cpu", train=True)
    loss, _, grads = loss_and_grads(tm, tm.param_tree(), batch)
    _close(loss, jloss, REL["float32"], "loss")
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    monkeypatch.setattr(TSSM, "ssd_chunked_ref", _recurrent_scan)
    _, _, ref = loss_and_grads(tm, tm.param_tree(), batch)
    for i, (g, r) in enumerate(zip(grads, ref, strict=True)):
        _close(g, r.numpy(), REL["float32"], f"grad {i}")
