"""The port's MoE feed-forward (``models.layers.moe_apply``) against the JAX
package's on the same weights and tokens, on the reduced qwen2-moe and
arctic configs: outputs and the aux loss at capacity_factor 1.25 (pairs
drop) and 16 (none do), with padded experts (``moe_pad_experts`` 12), and a
bf16 case whose router makes the logits tie at the K-th place and inside
the top K: the selected experts and the output must equal the reference's
(``jax.lax.top_k`` puts the lower index first). The reference's
``test_moe_dispatch_equals_dense_reference`` is mirrored on the port.

Tolerances, relative to each tensor's largest magnitude, as
``tests/test_torch_lm.py``: f32 1e-5; bf16 4e-2."""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch_train_cases import _close, one_thread  # noqa: E402,F401

from repro.configs import get_reduced_config as jax_config  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

REL = {"float32": 1e-5, "bfloat16": 4e-2}


def _pair(arch, dtype, seed, **over):
    """(reference cfg, port cfg, reference params, port params)."""
    jcfg = jax_config(arch).replace(dtype=dtype, **over)
    cfg = get_reduced_config(arch).replace(dtype=dtype, **over)
    jp, _ = RL.init_moe(jax.random.PRNGKey(seed), jcfg)
    return jcfg, cfg, jp, {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}


def _both(jcfg, cfg, jp, tp, x, dtype, drops=None):
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    tx = torch.tensor(x).to(getattr(torch, dtype))
    jy, jaux = jax.jit(functools.partial(RL.moe_apply, cfg=jcfg, act=jcfg.mlp_act))(jp, jx)
    ty, taux = TL.moe_apply(tp, tx, cfg, cfg.mlp_act, drops)
    return ty, taux, jy, jaux


def _routes(jcfg, cfg, jp, tp, x, dtype):
    """Each side's selected experts (T, K), the reference's by its own ops."""
    jx = jnp.asarray(x).astype(jnp.dtype(dtype)).reshape(-1, jcfg.d_model)
    logits = (jx @ jp["router"].astype(jx.dtype)).astype(jnp.float32)
    _, jtop = jax.lax.top_k(jax.nn.softmax(logits, -1), jcfg.top_k)
    tx = torch.tensor(x).to(getattr(torch, dtype)).reshape(-1, cfg.d_model)
    probs, ttop, _ = TL._route(tp, tx, cfg)
    return ttop, np.asarray(jtop), probs


@pytest.mark.parametrize("arch", ["qwen2_moe_a2_7b", "arctic_480b"])
@pytest.mark.parametrize("capacity,pad", [(1.25, 0), (16.0, 0), (1.25, 12)])
def test_moe_matches_jax(arch, capacity, pad):
    jcfg, cfg, jp, tp = _pair(arch, "float32", 0, capacity_factor=capacity, moe_pad_experts=pad)
    x = np.random.default_rng(1).standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    drops = TL.DropCounter()
    ty, taux, jy, jaux = _both(jcfg, cfg, jp, tp, x, "float32", drops)
    _close(ty, jy, REL["float32"], "out")
    _close(taux, jaux, REL["float32"], "aux")
    assert tp["wi_gate"].shape[0] == max(cfg.n_experts, pad)
    share = drops.shares()["prefill"]
    assert share["pairs"] == 32 * cfg.top_k
    # 1.25 drops pairs (the case exercises the capacity), 16 none
    assert (share["dropped"] > 0) == (capacity == 1.25), share


@pytest.mark.parametrize("arch", ["qwen2_moe_a2_7b", "arctic_480b"])
def test_moe_top_k_ties_match_jax(arch):
    """bf16 router columns that are multiples of one vector: every token's
    logits tie in groups of three (experts 1, 4, 6 the largest multiple,
    0, 3, 7 the smallest), so with K = 2 the top K holds a tie and the K-th
    place ties with the next; the selected experts and outputs equal the
    reference's, at a capacity where pairs drop (the ties set the flat
    order, and so the capacity positions)."""
    jcfg, cfg, jp, tp = _pair(arch, "bfloat16", 3, capacity_factor=1.25)
    assert cfg.top_k == 2 and cfg.n_experts == 8
    v = np.random.default_rng(4).standard_normal(cfg.d_model).astype(np.float32) * 0.1
    scale = np.asarray([-1.0, 3.0, 0.5, -1.0, 3.0, 1.0, 3.0, -1.0], np.float32)
    router = (v[:, None] * scale[None, :]).astype(np.float32)
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.tensor(router))
    x = np.random.default_rng(5).standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    ttop, jtop, probs = _routes(jcfg, cfg, jp, tp, x, "bfloat16")
    top3 = torch.sort(probs, -1, descending=True).values[:, :3]
    assert bool((top3[:, 0] == top3[:, 1]).all() and (top3[:, 1] == top3[:, 2]).all())
    assert set(jtop[:, 0].tolist()) == {0, 1}  # both signs of x·v occur
    np.testing.assert_array_equal(ttop.numpy(), jtop)
    drops = TL.DropCounter()
    ty, taux, jy, jaux = _both(jcfg, cfg, jp, tp, x, "bfloat16", drops)
    assert drops.shares()["prefill"]["dropped"] > 0
    _close(ty, jy, REL["bfloat16"], "out")
    _close(taux, jaux, REL["bfloat16"], "aux")


def test_moe_dispatch_equals_dense_reference():
    """The reference's own test on the port: scatter-based top-k dispatch
    equals a dense per-expert product (capacity high enough that nothing
    drops)."""
    cfg = get_reduced_config("qwen2_moe_a2_7b").replace(capacity_factor=16.0)
    params = TL.init_moe(torch.Generator().manual_seed(0), cfg)
    x = 0.5 * torch.randn(2, 8, cfg.d_model, generator=torch.Generator().manual_seed(1))
    y, _ = TL.moe_apply(params, x, cfg, cfg.mlp_act)

    T = 16
    xt = x.reshape(T, cfg.d_model)
    probs = torch.softmax(xt @ params["router"], -1)
    top_p, top_e = torch.topk(probs, cfg.top_k)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    h = torch.nn.functional.silu(torch.einsum("td,edf->tef", xt, params["wi_gate"]))
    h = h * torch.einsum("td,edf->tef", xt, params["wi_up"])
    y_all = torch.einsum("tef,efd->ted", h, params["wo"])  # (T, E, D)
    combine = torch.zeros(T, y_all.shape[1]).scatter(1, top_e, top_p)
    ref = torch.einsum("te,ted->td", combine, y_all).reshape(2, 8, cfg.d_model)
    np.testing.assert_allclose(y.numpy(), ref.numpy(), atol=1e-5)
