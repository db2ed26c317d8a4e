"""Plain PyTorch version of the SSD kernel: the chunked scan of
``repro/models/ssm.py::_ssd_chunked`` in f32 (as the Pallas kernel computes),
with the state carried in and out and T padded to a chunk multiple with
dt = 0 steps (``repro/kernels/ssd/ops.py``). It is also the scan the
training forward differentiates; its within-chunk decay is masked before
the exp, so its gradient stays finite where the reference's ``where``
after the exp gives NaN (a chunk whose decay overflows f32)."""
from __future__ import annotations

import torch


def ssd_chunked_ref(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    state0: torch.Tensor | None = None,
    *,
    chunk: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, T, H, P), dt (B, T, H) > 0, A (H,) < 0, Bm/Cm (B, T, 1, N),
    state0 (B, H, P, N) or None (zeros) → y (B, T, H, P) in x's dtype,
    state_T (B, H, P, N) f32."""
    Bt, T, H, P = x.shape
    N = Bm.shape[-1]
    Q = chunk
    pad = -T % Q
    f32 = torch.float32

    def padt(a):
        a = a.to(f32)
        return torch.cat([a, a.new_zeros((Bt, pad) + a.shape[2:])], 1) if pad else a

    xf, dtf = padt(x), padt(dt)
    Bf, Cf = padt(Bm[:, :, 0]), padt(Cm[:, :, 0])
    Af = A.to(f32)
    state = x.new_zeros((Bt, H, P, N), dtype=f32) if state0 is None else state0.to(f32)
    mask = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    ys = []
    for c in range((T + pad) // Q):
        sl = slice(c * Q, (c + 1) * Q)
        xq, dtq, Bq, Cq = xf[:, sl], dtf[:, sl], Bf[:, sl], Cf[:, sl]
        la = torch.cumsum(dtq * Af, dim=1)  # (B, Q, H)
        cb = torch.einsum("bin,bjn->bij", Cq, Bq)
        diff = la[:, :, None, :] - la[:, None, :, :]  # (B, i, j, H)
        # masked before the exp: the same forward as zeroing exp(diff) after it,
        # but exp of a masked (j > i) difference, which overflows f32 once a
        # chunk's decay passes e^88, no longer meets a zero gradient (0·inf)
        decay = torch.exp(diff.masked_fill(~mask[None, :, :, None], float("-inf")))
        xdt = xq * dtq[..., None]
        y = torch.einsum("bijh,bjhp->bihp", cb[..., None] * decay, xdt)
        y = y + torch.einsum("bin,bhpn->bihp", Cq, state) * torch.exp(la)[..., None]
        tail = torch.exp(la[:, -1:] - la)  # (B, Q, H) decay to the chunk's end
        add = torch.einsum("bjn,bjhp->bhpn", Bq, xdt * tail[..., None])
        state = state * torch.exp(la[:, -1])[:, :, None, None] + add
        ys.append(y)
    y = torch.cat(ys, 1)[:, :T] if ys else xf[:, :0]
    return y.to(x.dtype), state
