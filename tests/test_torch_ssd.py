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
