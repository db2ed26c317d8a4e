"""The port's training forward against the JAX package's ``loss_fn`` on the
same weights (reduced tinyllama, minicpm3, qwen2-moe, arctic, olmo-1b,
gemma-2b (also soft-capped), phi-3-vision with its patch prefix and
whisper-medium with its frames here, mamba2 in
``test_torch_train_loss_ssm.py``; the JAX params carried across by
``model_from_jax(train=True)``): the loss, its CE and aux, and the
gradient of every parameter leaf, with non-uniform example weights, the
blocked causal attention (``prefill_flash_block`` 8 at T = 32), a CE split
into chunks, and remat. The reference's blocked attention has no reverse
mode (a ``fori_loop`` with a dynamic stop), so there the loss is held to
the reference's blocked forward and the gradients to the reference's
gradient of the same function through ``_sdpa`` (``prefill_flash_block``
0). Also the two cross-entropies against the reference's.

Tolerances, relative to each tensor's largest magnitude, as
``tests/test_torch_lm.py``: f32 1e-5; bf16 activations 4e-2 (the
frameworks round to bf16 at other places, and the port keeps the SSD
scan's scores in f32 where the reference rounds them to bf16)."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch_train_cases import _close, check_loss_and_grads, one_thread  # noqa: E402,F401

from repro.models import layers as RL  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

CASES = [
    # (arch, dtype, overrides, build options, T, uniform weights)
    ("tinyllama_1b", "float32", {}, {}, 12, False),
    ("tinyllama_1b", "bfloat16", {}, {}, 12, False),
    ("tinyllama_1b", "float32", {"prefill_flash_block": 8}, {"xent_chunk": 8}, 32, False),
    ("tinyllama_1b", "bfloat16", {"prefill_flash_block": 8}, {}, 32, True),
    ("tinyllama_1b", "float32", {}, {"remat": "full"}, 16, False),
    ("tinyllama_1b", "float32", {}, {"remat": "dots", "xent_chunk": 5}, 15, False),
    ("minicpm3_4b", "float32", {}, {}, 12, False),
    ("minicpm3_4b", "bfloat16", {}, {"remat": "full"}, 12, False),
    ("qwen2_moe_a2_7b", "float32", {"capacity_factor": 1.25}, {}, 12, False),
    ("qwen2_moe_a2_7b", "bfloat16", {}, {"remat": "dots"}, 12, False),
    ("arctic_480b", "float32", {"moe_pad_experts": 12}, {"remat": "full"}, 12, False),
    ("olmo_1b", "float32", {}, {}, 12, False),
    ("olmo_1b", "bfloat16", {}, {"remat": "dots"}, 12, False),
    ("gemma_2b", "float32", {"logits_softcap": 2.0}, {}, 12, False),
    ("gemma_2b", "bfloat16", {}, {}, 12, True),
    ("phi3_vision_4b", "float32", {}, {}, 12, False),
    ("phi3_vision_4b", "bfloat16", {}, {"remat": "full"}, 12, False),
    ("whisper_medium", "float32", {}, {}, 12, False),
    ("whisper_medium", "float32", {}, {"remat": "dots", "xent_chunk": 5}, 15, False),
    ("whisper_medium", "bfloat16", {}, {}, 12, True),
]


@pytest.mark.parametrize("arch,dtype,over,opts,T,uniform", CASES,
                         ids=[f"{a}-{d}-{o}{p}-T{t}" for a, d, o, p, t, _ in CASES])
def test_loss_and_grads_match_jax(arch, dtype, over, opts, T, uniform):
    check_loss_and_grads(arch, dtype, over, opts, T, uniform)


@pytest.mark.parametrize("S,chunk", [(12, 512), (12, 5), (30, 8)])
def test_cross_entropies_match_jax(S, chunk):
    rng = np.random.default_rng(S + chunk)
    B, D, V = 3, 16, 40
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    table = rng.standard_normal((V, D)).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    w = rng.uniform(0.1, 2.0, B).astype(np.float32)
    logits = np.einsum("bsd,vd->bsv", x, table)
    ref = RL.softmax_xent_weighted(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(w))
    got = TL.softmax_xent_weighted(torch.tensor(logits), torch.tensor(labels), torch.tensor(w))
    _close(got, ref, 1e-6, "softmax_xent_weighted")
    ref = RL.chunked_xent_weighted(jnp.asarray(x), jnp.asarray(table), jnp.asarray(labels),
                                   jnp.asarray(w), chunk=chunk)
    got = TL.chunked_xent_weighted(torch.tensor(x), torch.tensor(table), torch.tensor(labels),
                                   torch.tensor(w), chunk=chunk)
    _close(got, ref, 1e-6, "chunked_xent_weighted")
