"""SSD wrapper: the CUDA kernel (``csrc/ssd.cu``) for CUDA tensors,
``ref.py`` for CPU tensors."""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.ssd.ref import ssd_chunked_ref

MAX_CHUNK = 256
MAX_N = 128
LAUNCHES = 0
# launches of each body, beside the total
PATH_LAUNCHES = {"mma": 0, "simt": 0}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PATH_CODE = {"simt": 0, "mma": 1}


def kernel_path(x: torch.Tensor, N: int) -> str:
    """Which body of the kernel x (B, T, H, P) and the state width N take:
    "mma" (bf16, P ∈ {32, 64}, N a multiple of 16: three chunk-parallel
    launches on the tensor cores at f32 accuracy) or "simt" (f32, or any
    other shape: one CTA per (b, h, 16 columns of P) walks the chunks on the
    CUDA cores)."""
    if x.dtype == torch.bfloat16 and x.shape[-1] in (32, 64) and N % 16 == 0:
        return "mma"
    return "simt"


def _aligned(t: torch.Tensor) -> bool:
    """16-byte aligned base and (b, t) strides, as the mma body loads rows
    (the state too: its base)."""
    return t.data_ptr() % 16 == 0 and t.stride(0) % 8 == 0 and t.stride(1) % 8 == 0


def ssd_chunked(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    state0: torch.Tensor | None = None,
    *,
    chunk: int,
    backend: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, T, H, P), dt (B, T, H) f32 > 0, A (H,) f32 < 0, Bm/Cm
    (B, T, 1, N) in x's dtype, state0 (B, H, P, N) f32 or None (zeros) →
    (y (B, T, H, P) in x's dtype, state_T (B, H, P, N) f32). The scan runs
    in chunks of ``chunk`` steps, in f32; T need not be a multiple of it.
    Where the mma body takes the call, an x, Bm or Cm whose base or (b, t)
    strides are not 16-byte aligned is copied first. The kernel has no
    backward: an input on the CUDA route that requires grad raises (train
    through ``ssd_chunked_ref``, as ``models.ssm`` does)."""
    global LAUNCHES
    Bt, T, H, P = x.shape
    N = Bm.shape[-1]
    if dt.shape != (Bt, T, H) or A.shape != (H,) or Bm.shape != Cm.shape or Bm.shape[:2] != (Bt, T):
        raise ValueError(
            f"ssd_chunked shapes: x {tuple(x.shape)}, dt {tuple(dt.shape)}, A {tuple(A.shape)}, "
            f"Bm {tuple(Bm.shape)}, Cm {tuple(Cm.shape)}"
        )
    if Bm.shape[2] != 1:
        raise ValueError(f"ssd_chunked shares B/C across heads (G = 1), got G = {Bm.shape[2]}")
    if state0 is not None and state0.shape != (Bt, H, P, N):
        raise ValueError(f"state0 must be {(Bt, H, P, N)}, got {tuple(state0.shape)}")
    if _lib.resolve_backend(backend, x, "ssd") == "torch":
        return ssd_chunked_ref(x, dt, A, Bm, Cm, state0, chunk=chunk)
    if any(t is not None and t.requires_grad for t in (x, dt, A, Bm, Cm, state0)):
        raise RuntimeError("the ssd kernel has no backward: an input requires grad "
                           "(train through ssd_chunked_ref)")
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise ValueError(f"the ssd kernel takes x, Bm, Cm in bf16 or f32 alike, got {x.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32 or (
        state0 is not None and state0.dtype != torch.float32
    ):
        raise ValueError("the ssd kernel takes dt, A and state0 in float32")
    if not 0 < chunk <= MAX_CHUNK or N > MAX_N:
        raise ValueError(f"the ssd kernel takes chunk ≤ {MAX_CHUNK} and N ≤ {MAX_N}")
    if x.stride(3) != 1 or x.stride(2) != P or dt.stride(2) != 1 or Bm.stride(3) != 1 or (
        Cm.stride(3) != 1
    ):
        raise ValueError("the ssd kernel reads x by (h, p) rows and dt, Bm, Cm with unit inner stride")
    _lib.require_cuda(A, state0)
    if len({t.device for t in (x, dt, A, Bm, Cm)}) != 1:
        raise ValueError("ssd_chunked inputs must lie on one CUDA device")
    path = kernel_path(x, N)
    if path == "mma":
        x, Bm, Cm = (t if _aligned(t) else t.contiguous() for t in (x, Bm, Cm))
        if state0 is not None and state0.data_ptr() % 16:
            state0 = state0.clone()
    nc = -(-T // chunk)
    y = torch.empty((Bt, T, H, P), dtype=x.dtype, device=x.device)
    state = torch.empty((Bt, H, P, N), dtype=torch.float32, device=x.device)
    # mma: chunk states, entering states and la_Q (f32); simt: the lower
    # triangle of C Bᵀ per (b, chunk)
    n_scratch = Bt * nc * (H * (8 * P * N + 4) if path == "mma" else 4 * chunk * chunk)
    scratch = torch.empty(n_scratch, dtype=torch.uint8, device=x.device)
    _lib.check(
        _lib.lib().repro_ssd(
            _lib.ptr(x), _lib.ptr(dt), _lib.ptr(A), _lib.ptr(Bm), _lib.ptr(Cm), _lib.ptr(state0),
            _lib.ptr(y), _lib.ptr(state), _lib.ptr(scratch), _DTYPES[x.dtype], _PATH_CODE[path],
            Bt, T, H, P, N, chunk, x.stride(0), x.stride(1), dt.stride(0), dt.stride(1),
            Bm.stride(0), Bm.stride(1), Cm.stride(0), Cm.stride(1), _lib.stream_ptr(x.device),
        ),
        "repro_ssd",
    )
    LAUNCHES += 1
    PATH_LAUNCHES[path] += 1
    return y, state
