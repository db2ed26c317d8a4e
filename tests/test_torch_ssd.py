"""The port's SSD plain version (the CPU path of ``repro_torch.kernels.ssd``)
against the JAX package's Pallas wrapper in interpret mode, its definitional
recurrence ``ssd_ref`` and the model's own chunked scan ``_ssd_chunked``.

The port takes the model's layout — x (B, T, H, P), B/C (B, T, 1, N) shared
by the heads — where the Pallas wrapper takes (B·H, T, ·) rows with B/C per
row; the tests feed the Pallas side B/C repeated over the heads. Tolerances:
atol 2e-4·max|y| against the Pallas kernel and ssd_ref (the reference's
tests/test_kernels.py); 1e-5·max against _ssd_chunked at f32 (the same
chunked arithmetic, sums in another order).
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.ssd.ops import ssd_chunked as jax_ssd  # noqa: E402
from repro.kernels.ssd.ref import ssd_ref  # noqa: E402
from repro.models.ssm import _ssd_chunked  # noqa: E402
from repro_torch.kernels.ssd import ops  # noqa: E402


def _inputs(B, T, H, P, N, seed, state=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, H, P)).astype(np.float32)
    dt = (rng.random((B, T, H)) * 0.5 + 0.01).astype(np.float32)
    A = (-rng.random((H,)) * 2 - 0.1).astype(np.float32)
    Bm = rng.standard_normal((B, T, 1, N)).astype(np.float32)
    Cm = rng.standard_normal((B, T, 1, N)).astype(np.float32)
    s0 = rng.standard_normal((B, H, P, N)).astype(np.float32) if state else None
    return x, dt, A, Bm, Cm, s0


def _rows(x, dt, A, Bm, Cm):
    """The Pallas wrapper's (B·H, T, ·) layout, B/C repeated over the heads."""
    B, T, H, P = x.shape
    N = Bm.shape[-1]
    return (x.transpose(0, 2, 1, 3).reshape(B * H, T, P), dt.transpose(0, 2, 1).reshape(B * H, T),
            np.tile(A, B), np.repeat(Bm[:, None, :, 0], H, 1).reshape(B * H, T, N),
            np.repeat(Cm[:, None, :, 0], H, 1).reshape(B * H, T, N))


def _port(*arrays, chunk):
    x, dt, A, Bm, Cm, s0 = (None if a is None else torch.from_numpy(a) for a in arrays)
    y, st = ops.ssd_chunked(x, dt, A, Bm, Cm, s0, chunk=chunk)
    return y.numpy(), st.numpy()


@pytest.mark.parametrize("T,chunk", [(64, 16), (100, 32), (256, 128), (31, 32)])
@pytest.mark.parametrize("P,N", [(16, 8), (64, 32)])
def test_ssd_ref_matches_pallas_kernel_and_recurrence(T, chunk, P, N):
    x, dt, A, Bm, Cm, _ = _inputs(1, T, 3, P, N, T + P)
    y, _ = _port(x, dt, A, Bm, Cm, None, chunk=chunk)
    y = y[0].transpose(1, 0, 2)  # (H, T, P)
    xr, dtr, Ar, Br, Cr = _rows(x, dt, A, Bm, Cm)
    yk = np.asarray(jax_ssd(*map(jnp.asarray, (xr, dtr, Ar, Br, Cr)), chunk=chunk))
    yr = np.asarray(ssd_ref(*map(jnp.asarray, (xr, dtr[..., None], Ar[:, None], Br, Cr))))
    scale = max(float(np.abs(yr).max()), 1.0)
    np.testing.assert_allclose(y, yk, rtol=0, atol=2e-4 * scale)
    np.testing.assert_allclose(y, yr, rtol=0, atol=2e-4 * scale)


@pytest.mark.parametrize("B,T,chunk", [(2, 64, 16), (1, 16, 16), (2, 96, 32)])
def test_ssd_ref_matches_model_chunked_scan_with_state(B, T, chunk):
    """Nonzero state0 in, state_T out: what the serve path's prefill needs
    and the Pallas kernel lacks."""
    x, dt, A, Bm, Cm, s0 = _inputs(B, T, 4, 16, 8, 7 + T, state=True)
    y, st = _port(x, dt, A, Bm, Cm, s0, chunk=chunk)
    ym, stm = _ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm, s0)), chunk=chunk)
    ym, stm = np.asarray(ym), np.asarray(stm)
    np.testing.assert_allclose(y, ym, rtol=0, atol=1e-5 * float(np.abs(ym).max()))
    np.testing.assert_allclose(st, stm, rtol=0, atol=1e-5 * float(np.abs(stm).max()))


def test_ssd_state_carries_across_calls():
    """One call over T equals two calls over T/2 with the state handed on,
    and zero-dt padding of a ragged T leaves the final state unchanged."""
    x, dt, A, Bm, Cm, s0 = _inputs(2, 48, 3, 16, 8, 1, state=True)
    y, st = _port(x, dt, A, Bm, Cm, s0, chunk=16)
    h = 24
    y1, st1 = _port(x[:, :h], dt[:, :h], A, Bm[:, :h], Cm[:, :h], s0, chunk=16)
    y2, st2 = _port(x[:, h:], dt[:, h:], A, Bm[:, h:], Cm[:, h:], st1, chunk=16)
    np.testing.assert_allclose(np.concatenate([y1, y2], 1), y, rtol=0, atol=1e-5)
    np.testing.assert_allclose(st2, st, rtol=0, atol=1e-5)


def test_ssd_dispatch_and_shapes():
    x, dt, A, Bm, Cm, _ = (None if a is None else torch.from_numpy(a)
                           for a in _inputs(1, 8, 2, 4, 4, 0))
    before = ops.LAUNCHES
    ops.ssd_chunked(x, dt, A, Bm, Cm, chunk=4)
    assert ops.LAUNCHES == before
    with pytest.raises(ValueError, match="does not run on a cpu tensor"):
        ops.ssd_chunked(x, dt, A, Bm, Cm, chunk=4, backend="cuda")
    with pytest.raises(ValueError, match="G = 1"):
        ops.ssd_chunked(x, dt, A, Bm.repeat(1, 1, 2, 1), Cm.repeat(1, 1, 2, 1), chunk=4)
    with pytest.raises(ValueError, match="state0"):
        ops.ssd_chunked(x, dt, A, Bm, Cm, torch.zeros(1, 2, 4, 5), chunk=4)


# ---- the algebra of the kernel's "mma" body (csrc/ssd.cu), in plain torch:
# the chunk-parallel decomposition (chunk states, a pass over the chunks,
# chunk scans) with every f32 × bf16 product taken as three bf16 products.
# The body itself runs only on the card (tests/test_torch_cuda.py); this
# checks its design here. Inputs x, B, C are bf16 values (exact bf16
# operands, as on the serve path) held in f32.


def _split3(v):
    """v = hi + mid + lo in three bf16 tensors, as the kernel splits an f32
    operand (8 significant bits each)."""
    hi = v.to(torch.bfloat16)
    r = v - hi.float()
    mid = r.to(torch.bfloat16)
    lo = (r - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def _mm3(a, b, *, split):
    """a @ b with the f32 operand (``split`` = "a" or "b") in three bf16
    pieces, each product summed in f32, the small pieces first."""
    out = None
    for piece in reversed(_split3(a if split == "a" else b)):
        prod = piece.float() @ b if split == "a" else a @ piece.float()
        out = prod if out is None else out + prod
    return out


def _ssd_three_phase(x, dt, A, Bm, Cm, state0, chunk):
    """The mma body's decomposition: (y, state_T), both f32."""
    Bt, T, H, P = x.shape
    N = Bm.shape[-1]
    Q = chunk
    nc = -(-T // Q)
    pad = nc * Q - T

    def chunks(a):
        a = torch.cat([a, a.new_zeros((Bt, pad) + a.shape[2:])], 1) if pad else a
        return a.reshape((Bt, nc, Q) + a.shape[2:])

    xq, dtq = chunks(x), chunks(dt)                      # (B, nc, Q, H, P), (B, nc, Q, H)
    Bq, Cq = chunks(Bm[:, :, 0]), chunks(Cm[:, :, 0])    # (B, nc, Q, N)
    la = torch.cumsum(dtq * A, dim=2)                    # (B, nc, Q, H)
    la_q = la[:, :, -1]                                  # (B, nc, H)
    xh = xq.permute(0, 1, 3, 2, 4)                       # (B, nc, H, Q, P)
    # 1. chunk states S_c = (B ⊙ dt ⊙ e^{la_Q − la})ᵀ x, every chunk alone
    w = (dtq * torch.exp(la_q[:, :, None] - la)).permute(0, 1, 3, 2)       # (B, nc, H, Q)
    a = (Bq[:, :, None] * w[..., None]).transpose(-1, -2)                   # (B, nc, H, N, Q)
    S = _mm3(a, xh, split="a")                                              # (B, nc, H, N, P)
    # 2. state passing: the state entering each chunk, and the last
    h = torch.zeros((Bt, H, P, N)) if state0 is None else state0
    entering = []
    for c in range(nc):
        entering.append(h)
        h = h * torch.exp(la_q[:, c])[:, :, None, None] + S[:, c].transpose(-1, -2)
    hc = torch.stack(entering, 1)                                           # (B, nc, H, P, N)
    # 3. chunk scans: e^{la_i} C_i·h_c + Σ_{j ≤ i} (C Bᵀ ⊙ e^{la_i − la_j} ⊙ dt_j) x_j
    inter = _mm3(Cq[:, :, None], hc.transpose(-1, -2), split="b")           # (B, nc, H, Q, P)
    lah = la.permute(0, 1, 3, 2)                                            # (B, nc, H, Q)
    inter = inter * torch.exp(lah)[..., None]
    cb = Cq @ Bq.transpose(-1, -2)                                          # (B, nc, Q, Q)
    diff = lah[..., :, None] - lah[..., None, :]
    keep = torch.ones((Q, Q), dtype=torch.bool).tril()
    m = torch.where(keep, cb[:, :, None] * torch.exp(diff) * dtq.permute(0, 1, 3, 2)[..., None, :],
                    torch.zeros(()))
    y = inter + _mm3(m, xh, split="a")                                      # (B, nc, H, Q, P)
    y = y.permute(0, 1, 3, 2, 4).reshape(Bt, nc * Q, H, P)[:, :T]
    return y, h


def _bf16_exact(a):
    return torch.from_numpy(a).bfloat16().float()


@pytest.mark.parametrize("B,T,H,P,N,chunk,state", [
    (1, 64, 3, 16, 16, 64, False),   # nc = 1
    (2, 50, 3, 16, 16, 64, True),    # nc = 1, ragged T
    (1, 256, 2, 32, 32, 64, False),  # nc = 4
    (2, 200, 3, 16, 16, 64, True),   # nc = 4, ragged T
])
def test_three_phase_bf16x3_matches_ref_and_jax(B, T, H, P, N, chunk, state):
    """The mma body's algebra against the port's plain version (f32, chunks
    in series) within 1e-5·max, and against the JAX package: the Pallas
    kernel in interpret mode without a state (2e-4·max, its own tests'
    bound), the model's chunked scan with one (1e-5·max)."""
    x, dt, A, Bm, Cm, s0 = _inputs(B, T, H, P, N, 3 * T + P, state=state)
    x, Bm, Cm = (_bf16_exact(a) for a in (x, Bm, Cm))
    dt_t, A_t = torch.from_numpy(dt), torch.from_numpy(A)
    s0_t = None if s0 is None else torch.from_numpy(s0)
    y, st = _ssd_three_phase(x, dt_t, A_t, Bm, Cm, s0_t, chunk)
    yr, sr = ops.ssd_chunked(x, dt_t, A_t, Bm, Cm, s0_t, chunk=chunk)
    scale = float(yr.abs().max())
    np.testing.assert_allclose(y.numpy(), yr.numpy(), rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(st.numpy(), sr.numpy(), rtol=0, atol=1e-5 * float(sr.abs().max()))
    xn, Bn, Cn = x.numpy(), Bm.numpy(), Cm.numpy()
    if state:
        # the model's scan takes whole chunks: pad with dt = 0 steps, which
        # leave the state as it is (the Pallas wrapper's own padding)
        pad = [(0, 0), (0, -T % chunk)]
        xp, dtp, Bp, Cp = (np.pad(a, pad + [(0, 0)] * (a.ndim - 2)) for a in (xn, dt, Bn, Cn))
        ym, stm = _ssd_chunked(*map(jnp.asarray, (xp, dtp, A, Bp, Cp, s0)), chunk=chunk)
        np.testing.assert_allclose(y.numpy(), np.asarray(ym)[:, :T], rtol=0, atol=1e-5 * scale)
        np.testing.assert_allclose(st.numpy(), np.asarray(stm), rtol=0,
                                   atol=1e-5 * float(np.abs(np.asarray(stm)).max()))
    else:
        xr, dtr, Ar, Br, Cr = _rows(xn, dt, A, Bn, Cn)
        yk = np.asarray(jax_ssd(*map(jnp.asarray, (xr, dtr, Ar, Br, Cr)), chunk=chunk))
        np.testing.assert_allclose(y[0].numpy().transpose(1, 0, 2), yk, rtol=0, atol=2e-4 * scale)


@pytest.mark.parametrize("scale", [1.0, 1e-30, 1e30, 3.7e-5])
def test_bf16x3_split_reconstructs_f32(scale):
    """hi + mid + lo gives back the f32 value within 2⁻²⁴ of it, over f32's
    exponent range (the pieces are bf16, which keeps f32's exponent); below
    |v| ≈ 2⁻¹⁰⁹ the last piece turns subnormal and the error stays under
    f32's smallest normal, 2⁻¹²⁶."""
    rng = np.random.default_rng(int(np.log2(scale) + 200))
    v = torch.from_numpy((rng.standard_normal(20_000) * scale).astype(np.float32))
    v[:3] = torch.tensor([0.0, scale, -scale])
    hi, mid, lo = _split3(v)
    back = hi.double() + mid.double() + lo.double()
    err = (back - v.double()).abs()
    assert bool((err <= 2.0 ** -24 * v.double().abs() + 2.0 ** -126).all())
    normal = v.double().abs() >= 2.0 ** -109
    assert bool((err[normal] <= 2.0 ** -24 * v.double().abs()[normal]).all())
    # hi alone is bf16 (8 bits): far from f32 accuracy
    rel_hi = (hi.double() - v.double()).abs() / v.double().abs().clamp_min(1e-300)
    assert float(rel_hi.max()) > 2.0 ** -12
