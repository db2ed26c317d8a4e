"""Flash-attention wrapper: the CUDA kernel (``csrc/flash_attention.cu``)
for CUDA tensors, ``ref.py`` for CPU tensors."""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.flash_attention.ref import flash_attention_ref, key_tiles

_C = _lib.CUDA_CONSTANTS["flash_attention.cu"]
MAX_D = _C["kFlashMaxD"]  # 256
ROWS = _C["kWgRows"]  # q rows a wgmma CTA takes
LAUNCHES = 0
# launches of each body, beside the total
PATH_LAUNCHES = {"wgmma": 0, "mma": 0, "simt": 0}
# launches by mask: causal, or every key attended (an encoder's)
MASK_LAUNCHES = {"causal": 0, "full": 0}
# wgmma launches whose grid split the heaviest q tiles' key ranges
SPLIT_LAUNCHES = 0
_TICKETS: dict = {}  # (device index, stream) → the split grid's int32 tickets, left zero
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PATH_CODE = {"simt": 0, "mma": 1, "wgmma": 2}


def kernel_path(q: torch.Tensor) -> str:
    """Which body of the kernel q's dtype and width take: "wgmma" (bf16,
    d ∈ {64, 96, 128, 256}: Hopper warpgroup tensor cores fed by TMA; key
    tiles of 64 at d = 256, of 128 below; d = 96 in two 64-column chunks,
    the second zero-filled past 96), "mma" (bf16, d ∈ {16, 32}: mma.sync
    tensor cores) or "simt" (f32 FMA: f32, or any other d ≤ MAX_D)."""
    if q.dtype == torch.bfloat16 and q.shape[-1] in (64, 96, 128, 256):
        return "wgmma"
    if q.dtype == torch.bfloat16 and q.shape[-1] in (16, 32):
        return "mma"
    return "simt"


def _key_tiles(S: int, d: int, causal: bool) -> list[int]:
    return key_tiles(S, _C["kWgKeysWide"] if d > 128 else _C["kWgKeys"], causal, ROWS)


def _slots(tiles: list[int], heads: int, cap: int) -> int:
    return heads * sum(p for p in (-(-n // cap) for n in tiles) if p > 1)


@functools.lru_cache(maxsize=256)
def split_plan(S: int, heads: int, d: int, causal: bool, n_sm: int) -> tuple[int, int]:
    """The wgmma body's grid over B·H = ``heads`` heads on ``n_sm`` SMs (one
    CTA an SM): (cap, slots). A CTA walks at most cap key tiles of a q
    tile's; slots > 0 counts the parts of split q tiles (a workspace of
    slots × ROWS × (d + kPartPad + 2) floats for the partial of the part
    that finishes first, which the other merges). Where the unsplit grid
    leaves SMs idle, cap is the least (at least kSplitMinCap, at most
    kSplitMaxParts parts a q tile) that keeps every CTA in one wave, so the
    heaviest q tiles stop setting the time; else the heaviest q tile's
    count (no split)."""
    tiles = _key_tiles(S, d, causal)
    top = max(tiles)
    if heads * len(tiles) < n_sm:
        lo = max(_C["kSplitMinCap"], -(-heads * sum(tiles) // n_sm))
        for cap in range(lo, top):
            parts = [-(-n // cap) for n in tiles]
            if heads * sum(parts) <= n_sm and max(parts) <= _C["kSplitMaxParts"]:
                return cap, _slots(tiles, heads, cap)
    return top, 0


def _tickets(device: torch.device, stream: int, n: int) -> torch.Tensor:
    t = _TICKETS.get((device.index, stream))
    if t is None or t.numel() < n:
        t = _TICKETS[(device.index, stream)] = torch.zeros(n, dtype=torch.int32, device=device)
    return t


def _aligned(t: torch.Tensor) -> bool:
    """16-byte aligned base and (b, s, h) strides, as the tensor-core bodies
    load rows (TMA needs the same)."""
    return t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:-1])


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    backend: str | None = None,
) -> torch.Tensor:
    """q (B, S, H, d), k/v (B, S, KV, d) with H % KV == 0, bf16 or f32 →
    (B, S, H, d) in q's dtype. Causal masks key j > query i. Inputs are read
    through their strides (unit stride along d); where the tensor-core body
    takes them, an input whose base or strides are not 16-byte aligned is
    copied first. The output is contiguous. The kernel has no backward: an
    input on the CUDA route that requires grad raises (training attends
    through ``models.layers._sdpa``)."""
    global LAUNCHES, SPLIT_LAUNCHES
    if q.ndim != 4 or k.shape != v.shape or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]:
        raise ValueError(
            f"flash_attention wants q (B, S, H, d), k/v (B, S, KV, d); got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, S, H, d = q.shape
    KV = k.shape[2]
    if H % KV:
        raise ValueError(f"H = {H} is not a multiple of KV = {KV}")
    if _lib.resolve_backend(backend, q, "flash_attention") == "torch":
        return flash_attention_ref(q, k, v, causal=causal)
    if any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("the flash_attention kernel has no backward: an input requires grad "
                           "(train through models.layers._sdpa)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"the flash_attention kernel takes bf16 or f32, got {q.dtype}")
    if d > MAX_D:
        raise ValueError(f"the flash_attention kernel supports d ≤ {MAX_D}, got {d}")
    if len({t.device for t in (q, k, v)}) != 1 or any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q, k, v must share one CUDA device and have unit stride along d")
    path = kernel_path(q)
    if path != "simt":
        q, k, v = (t if _aligned(t) else t.clone(memory_format=torch.contiguous_format)
                   for t in (q, k, v))
    o, split = _launch(q, k, v, causal, path)
    LAUNCHES += 1
    PATH_LAUNCHES[path] += 1
    SPLIT_LAUNCHES += split
    MASK_LAUNCHES["causal" if causal else "full"] += 1
    return o


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, path: str,
            cap: int | None = None) -> tuple[torch.Tensor, bool]:
    """One launch of body ``path`` on inputs the wrapper has checked (and
    aligned), without the counts: the wrapper's, and the way to time one
    body or grid against another on the same inputs. On the wgmma body
    ``cap`` (key tiles a CTA) overrides ``split_plan``'s; the heaviest q
    tile's count gives the unsplit grid. Returns (o, whether it split)."""
    B, S, H, d = q.shape
    KV = k.shape[2]
    o = torch.empty((B, S, H, d), dtype=q.dtype, device=q.device)
    stream = _lib.stream_ptr(q.device)
    cap_, slots, work, tickets = 0, 0, None, None
    if path == "wgmma":
        cap_, slots = split_plan(S, B * H, d, causal, _lib.sm_count(q.device.index))
        if cap is not None:
            cap_, slots = cap, _slots(_key_tiles(S, d, causal), B * H, cap)
    if slots:
        work = torch.empty(slots * ROWS * (d + _C["kPartPad"] + 2), dtype=torch.float32,
                           device=q.device)
        tickets = _tickets(q.device, stream, 2 * slots)
    _lib.check(
        _lib.lib().repro_flash_attention(
            _lib.ptr(q), _lib.ptr(k), _lib.ptr(v), _lib.ptr(o), _DTYPES[q.dtype],
            _PATH_CODE[path], B, S, H, KV, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            int(causal), d ** -0.5, cap_, _lib.ptr(work), slots, _lib.ptr(tickets), stream,
        ),
        "repro_flash_attention",
    )
    return o, bool(slots)
