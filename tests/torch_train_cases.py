"""The loss-and-gradient comparison of the LM training forward, port
against the JAX package, shared by ``test_torch_train_loss.py`` (dense,
MoE, the vision prefix, encdec) and ``test_torch_train_loss_ssm.py``
(mamba2); the tolerances are stated there."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jax_config
from repro.models import build_model as jax_build
from repro_torch.configs import get_reduced_config
from repro_torch.models import model_from_jax
from repro_torch.train.trainer import loss_and_grads
from torch_threads import one_thread  # noqa: F401

REL = {"float32": 1e-5, "bfloat16": 4e-2}


def _close(got, ref, rel, what):
    ref = np.asarray(ref, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == ref.shape, what
    err = float(np.abs(got - ref).max())
    assert err <= rel * max(float(np.abs(ref).max()), 1e-30), f"{what}: max err {err:.3e}"


def _batch(cfg, B, T, seed, uniform=False):
    """Tokens, labels and weights, with the config's modality stubs: a
    vision config's patch embeddings, an encdec config's frames (T + 3 of
    them: the encoder's length differs from the decoder's)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, T + 1)).astype(np.int32)
    w = np.ones(B, np.float32) if uniform else rng.uniform(0.2, 3.0, B).astype(np.float32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:], "weights": w}
    return with_stubs(cfg, batch, rng)


def with_stubs(cfg, batch, rng):
    """``batch`` with the stubs of ``tests/test_models_smoke.py``'s batches
    (N(0, 0.02²) float32) that the config's model reads."""
    B, T = batch["tokens"].shape
    if cfg.modality == "vision":
        batch["patch_embeds"] = (rng.standard_normal((B, cfg.n_modality_positions, cfg.d_model))
                                 * 0.02).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = (rng.standard_normal((B, T + 3, cfg.d_model)) * 0.02).astype(np.float32)
    return batch


def check_loss_and_grads(arch, dtype, over, opts, T, uniform):
    """The loss, its CE and aux (the MoE router's; 0 elsewhere) and every
    leaf's gradient, port against reference, on the reference's weights and
    one batch."""
    jcfg = jax_config(arch).replace(dtype=dtype, **over)
    jm = jax_build(jcfg, **opts)
    params, _ = jm.init(jax.random.PRNGKey(T))
    np_params = jax.tree.map(np.asarray, params)
    tm = model_from_jax(get_reduced_config(arch).replace(dtype=dtype, **over), np_params,
                        device="cpu", train=True, **opts)
    batch = _batch(jcfg, 3, T, T, uniform)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    if uniform:
        del batch["weights"], jbatch["weights"]  # the default: ones
    if over.get("prefill_flash_block"):
        jloss, jmet = jax.jit(jm.loss_fn)(params, jbatch)
        dense = jax_build(jcfg.replace(prefill_flash_block=0), **opts)
        jgrads = jax.jit(jax.grad(lambda p: dense.loss_fn(p, jbatch)[0]))(params)
    else:
        (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(
            params, jbatch)
    loss, met, grads = loss_and_grads(tm, tm.param_tree(), batch)
    rel = REL[dtype]
    _close(loss, jloss, rel, "loss")
    _close(met["ce"], jmet["ce"], rel, "ce")
    if jcfg.family == "moe":
        assert float(jmet["aux"]) > 0
        _close(met["aux"], jmet["aux"], rel, "aux")
    else:
        assert float(met["aux"]) == float(jmet["aux"]) == 0.0
    jleaves = jax.tree_util.tree_leaves_with_path(jgrads)
    assert len(grads) == len(jleaves)
    for g, (path, jg) in zip(grads, jleaves):
        assert g.dtype == torch.float32
        _close(g, jg, rel, f"grad {jax.tree_util.keystr(path)}")


