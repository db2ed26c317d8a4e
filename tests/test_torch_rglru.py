"""The port's RG-LRU block (``repro_torch.models.rglru``) against the JAX
package's on the same numpy inputs and weights: the scan (the algorithm of
``jax.lax.associative_scan`` written in torch) at odd and even lengths, from
a nonzero state, with the carry in f32 and in bf16; the whole block's
prefill and its one-token decode step, with the cache's bf16 conv tail in an
f32 model. Also the scan against a plain loop over the steps.

Tolerances, relative to each tensor's largest magnitude: f32 1e-5 (the same
products in the same order; the frameworks may fuse a multiply-add);
a bf16 carry or bf16 activations 4e-2, as ``tests/test_torch_lm.py``; the
bf16 conv tail within one bf16 ulp (2^-8)."""
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_reduced_config as jax_config  # noqa: E402
from repro.models import rglru as RR  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.models import rglru as TR  # noqa: E402

REL = {"float32": 1e-5, "bfloat16": 4e-2}


def _close(got, ref, rel, what):
    ref = np.asarray(ref, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == ref.shape, what
    err = float(np.abs(got - ref).max())
    assert err <= rel * max(float(np.abs(ref).max()), 1e-30), f"{what}: max err {err:.3e}"


def _block(dtype="float32", seed=0):
    """The reference's block params (numpy) and the port's on the same numbers."""
    cfg = jax_config("recurrentgemma_2b").replace(dtype=dtype)
    params, _ = RR.init_rglru_block(jax.random.PRNGKey(seed), cfg)
    np_params = jax.tree.map(np.asarray, params)
    return cfg, params, {k: torch.tensor(v) for k, v in np_params.items()}


@pytest.mark.parametrize("T", [1, 2, 7, 64])
@pytest.mark.parametrize("scan_dtype", ["float32", "bfloat16"])
def test_scan_matches_reference(T, scan_dtype):
    cfg, params, tparams = _block()
    rng = np.random.default_rng(T)
    W = cfg.lru_width
    xw = rng.standard_normal((2, T, W)).astype(np.float32)
    h0 = rng.standard_normal((2, W)).astype(np.float32)
    y, hT = RR._rglru_scan(jnp.asarray(xw), params, jnp.asarray(h0),
                           scan_dtype=jnp.dtype(scan_dtype))
    ty, thT = TR._rglru_scan(torch.tensor(xw), tparams, torch.tensor(h0),
                             scan_dtype=getattr(torch, scan_dtype))
    assert ty.dtype == torch.float32 and thT.dtype == torch.float32
    _close(ty, y, REL[scan_dtype], "y")
    _close(thT, hT, REL[scan_dtype], "h_T")


@pytest.mark.parametrize("T", [1, 2, 7, 64])
def test_associative_scan_is_the_recurrence(T):
    """The scan's result is h_t = a_t h_{t-1} + b_t stepped in order."""
    rng = np.random.default_rng(T + 100)
    a = torch.tensor(rng.uniform(0.5, 1.0, (3, T, 5)))
    b = torch.tensor(rng.standard_normal((3, T, 5)))
    _, h = TR.associative_scan(a, b)
    want, prev = [], torch.zeros(3, 5, dtype=a.dtype)
    for t in range(T):
        prev = a[:, t] * prev + b[:, t] if t else b[:, 0]
        want.append(prev)
    torch.testing.assert_close(h, torch.stack(want, 1), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [1, 7, 64])
def test_block_prefill_and_decode_match_reference(dtype, T):
    """Prefill from an empty cache (T = 1 takes the one-token step, as in
    the reference), then three decode steps, each from the reference's
    cache of the step before."""
    cfg, params, tparams = _block(dtype, seed=T)
    tcfg = get_reduced_config("recurrentgemma_2b").replace(dtype=dtype)
    tparams = {k: v.to(torch.float32 if k == "lam" else getattr(torch, dtype))
               for k, v in tparams.items()}
    rel = REL[dtype]
    rng = np.random.default_rng(T)
    x = rng.standard_normal((2, T, cfg.d_model)).astype(np.float32)
    jcache, _ = RR.init_rglru_cache(cfg, 2, 1)
    jcache = {k: (v[0] if k != "pos" else v) for k, v in jcache.items()}
    tcache = TR.init_rglru_cache(tcfg, 2, 1)
    tcache = {k: (v[0] if k != "pos" else v) for k, v in tcache.items()}
    assert tcache["conv"].dtype == torch.bfloat16 and tcache["h"].dtype == torch.float32
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    out, jcache = RR.rglru_block_apply(params, jx, cfg, cache=jcache)
    tout, tcache = TR.rglru_block_apply(tparams, torch.tensor(x).to(getattr(torch, dtype)), tcfg,
                                        cache=tcache)
    _close(tout, out, rel, "prefill out")
    for step in range(4):
        _close(tcache["conv"], jcache["conv"], max(rel, 2.0 ** -8), f"conv {step}")
        assert tcache["conv"].dtype == torch.bfloat16
        _close(tcache["h"], jcache["h"], rel, f"h {step}")
        assert int(tcache["pos"]) == int(jcache["pos"]) == T + step
        if step == 3:
            break
        tcache["conv"].copy_(torch.tensor(np.asarray(jcache["conv"], np.float32)))
        tcache["h"].copy_(torch.tensor(np.asarray(jcache["h"])))
        xs = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        out, jcache = RR.rglru_block_apply(params, jnp.asarray(xs).astype(jnp.dtype(dtype)), cfg,
                                           cache=jcache)
        tout, tcache = TR.rglru_block_apply(tparams, torch.tensor(xs).to(getattr(torch, dtype)),
                                            tcfg, cache=tcache)
        _close(tout, out, rel, f"decode {step} out")


def test_block_without_a_cache_matches_reference():
    """The training forward (no cache): the scan from a zero state."""
    cfg, params, tparams = _block(seed=3)
    x = np.random.default_rng(3).standard_normal((2, 20, cfg.d_model)).astype(np.float32)
    out, cache = RR.rglru_block_apply(params, jnp.asarray(x), cfg)
    tout, tcache = TR.rglru_block_apply(tparams, torch.tensor(x),
                                        get_reduced_config("recurrentgemma_2b"))
    assert cache is None and tcache is None
    _close(tout, out, REL["float32"], "out")
