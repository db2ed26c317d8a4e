"""The port's flash-attention plain version (the CPU path of
``repro_torch.kernels.flash_attention``) against the JAX package's Pallas
kernel in interpret mode and against its ``attention_ref`` oracle, on the
same numpy inputs.

Tolerances are the reference's own (tests/test_kernels.py): f32 atol 2e-5
(sums in another order), bf16 atol 3e-2 (the output's rounding; both sides
keep the softmax weights in f32).
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention.ops import flash_attention as jax_flash  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402


def _inputs(B, S, H, KV, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((B, S, H, d), (B, S, KV, d), (B, S, KV, d)))


def _oracle(q, k, v, causal):
    """attention_ref on the flattened (B·H, S, d) layout, kv heads repeated."""
    B, S, H, d = q.shape
    g = H // k.shape[2]

    def flat(a):
        return jnp.asarray(a).transpose(0, 2, 1, 3).reshape(B * H, S, d)

    ref = attention_ref(flat(q), flat(np.repeat(k, g, 2)), flat(np.repeat(v, g, 2)), causal=causal)
    return np.asarray(ref, np.float32).reshape(B, H, S, d).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("B,S,H,KV,d", [(1, 128, 2, 2, 32), (2, 256, 4, 2, 64), (1, 512, 8, 1, 64),
                                       (1, 128, 4, 1, 256)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_ref_matches_pallas_kernel(B, S, H, KV, d, causal):
    q, k, v = _inputs(B, S, H, KV, d, S + H)
    ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                               block_q=64, block_k=64))
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)
    np.testing.assert_allclose(got, _oracle(q, k, v, causal), rtol=0, atol=2e-5)


@pytest.mark.parametrize("S", [1, 37, 100, 129])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_ref_ragged_matches_attention_ref(S, causal):
    """S that no block divides: the Pallas kernel refuses it, the oracle and
    the port's kernel (which masks the ragged edge) take it."""
    q, k, v = _inputs(2, S, 8, 2, 16, S)
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal).numpy()
    np.testing.assert_allclose(got, _oracle(q, k, v, causal), rtol=0, atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_ref_bf16_matches_pallas_kernel(causal):
    q, k, v = (a.astype(jnp.bfloat16) for a in map(jnp.asarray, _inputs(1, 128, 2, 2, 64, 0)))
    ref = np.asarray(jax_flash(q, k, v, causal=causal, block_q=64, block_k=64), np.float32)
    tq, tk, tv = (torch.from_numpy(np.asarray(a, np.float32)).bfloat16() for a in (q, k, v))
    got = ops.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=3e-2)


def test_flash_dispatch_follows_the_tensor():
    q = torch.zeros(1, 4, 2, 8)
    before = ops.LAUNCHES
    ops.flash_attention(q, q[:, :, :1], q[:, :, :1])
    assert ops.LAUNCHES == before  # the CPU path launches nothing
    with pytest.raises(ValueError, match="does not run on a cpu tensor"):
        ops.flash_attention(q, q, q, backend="cuda")
    with pytest.raises(ValueError, match="unknown flash_attention backend"):
        ops.flash_attention(q, q, q, backend="pallas")
    with pytest.raises(ValueError, match="multiple"):
        ops.flash_attention(torch.zeros(1, 4, 3, 8), q, q)


@pytest.mark.parametrize("dtype,d,path", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"), (torch.bfloat16, 16, "mma"),
    (torch.bfloat16, 32, "mma"), (torch.bfloat16, 48, "simt"), (torch.bfloat16, 8, "simt"),
    (torch.float32, 64, "simt"), (torch.float32, 128, "simt"), (torch.float16, 64, "simt"),
    (torch.bfloat16, 96, "wgmma"), (torch.bfloat16, 256, "wgmma"), (torch.bfloat16, 80, "simt"),
    (torch.bfloat16, 160, "simt"), (torch.float32, 96, "simt"),
])
def test_flash_kernel_path_picks_the_body(dtype, d, path):
    """bf16 at the zoo's head widths (64, 96, 128, 256) takes the wgmma
    body, bf16 at 16 and 32 the mma.sync body, anything else the f32-FMA
    body."""
    assert ops.kernel_path(torch.zeros(1, 2, 2, d, dtype=dtype)) == path
    assert set(ops.PATH_LAUNCHES) == {"wgmma", "mma", "simt"}


@pytest.mark.parametrize("S,heads,d,causal,n_sm,want", [
    # recurrentgemma-2b's and gemma-2b's prefill at d = 256 (64-key tiles):
    # 80 and 64 CTAs unsplit; the q tiles past 8 key tiles in two parts,
    # 120 and 96 CTAs in one wave of 132
    (1024, 10, 256, True, 132, (8, 80)), (1024, 8, 256, True, 132, (8, 64)),
    # the grids that already fill the card stay whole: qwen2-moe and olmo
    # (128 CTAs), tinyllama (256), phi-3-vision (320), whisper's encoder
    (1024, 16, 128, True, 132, (8, 0)), (1024, 32, 64, True, 132, (8, 0)),
    (1280, 32, 96, True, 132, (10, 0)), (1500, 64, 64, False, 132, (12, 0)),
    # non-causal, every q tile alike: two parts each would be 160 CTAs
    (1024, 10, 256, False, 132, (16, 0)), (1024, 8, 256, False, 132, (8, 128)),
    # a split grid caps a CTA at kSplitMinCap key tiles at least, and a q
    # tile at kSplitMaxParts parts
    (256, 32, 64, True, 132, (2, 0)), (512, 10, 256, True, 132, (4, 40)),
    (1280, 4, 96, True, 132, (5, 40)), (2048, 1, 64, True, 132, (8, 16)),
])
def test_flash_split_plan(S, heads, d, causal, n_sm, want):
    """The wgmma grid splits the heaviest q tiles' key ranges only where the
    unsplit grid leaves SMs idle, into the fewest key tiles a CTA that keep
    every CTA in one wave; the slots count the split parts."""
    from repro_torch.kernels.flash_attention.ref import key_tiles

    cap, slots = ops.split_plan(S, heads, d, causal, n_sm)
    assert (cap, slots) == want
    tiles = key_tiles(S, 64 if d > 128 else 128, causal, ops.ROWS)
    parts = [-(-n // cap) for n in tiles]
    assert slots == heads * sum(p for p in parts if p > 1)
    assert heads * sum(parts) <= n_sm or slots == 0
    assert max(parts) <= ops._C["kSplitMaxParts"]


@pytest.mark.parametrize("B,S,H,KV,d,kt", [(1, 300, 2, 1, 64, 64), (2, 257, 4, 2, 32, 128),
                                          (1, 129, 2, 2, 16, 64)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("cap", [1, 2, 3, 64])
def test_flash_split_model_matches_attention_ref(B, S, H, KV, d, kt, causal, cap):
    """The split grid's arithmetic (each part alone, then the merge of the
    parts' O, max and sum in part order) is attention: the plain model
    against the JAX package's ``attention_ref`` at the reference's f32
    tolerance, for every cap down to one key tile a part (where a causal
    part above a row's diagonal holds no key of it)."""
    from repro_torch.kernels.flash_attention.ref import split_attention_ref

    q, k, v = _inputs(B, S, H, KV, d, S + cap)
    got = split_attention_ref(*map(torch.from_numpy, (q, k, v)), causal=causal, cap=cap, kt=kt,
                              rows=128).numpy()
    np.testing.assert_allclose(got, _oracle(q, k, v, causal), rtol=0, atol=2e-5)
