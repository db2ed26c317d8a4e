"""Mamba2 / SSD block (``repro/models/ssm.py``): attention-free mixing.

With a cache, the multi-token (prefill) branch runs the chunked SSD scan
through the SSD kernel (``kernels/ssd``), which takes the state from the
cache and returns the final state; the one-token decode step is one plain
recurrent step, as in the reference. Caches are written in place. Without
a cache (training) the scan is the kernel's plain version,
``ssd_chunked_ref``, called by name: the reference trains through its jnp
twin too, and the kernel has no backward (its wrapper refuses an input
that requires grad). Weights are cast to the activation dtype at use.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import local_blocks
from repro_torch.kernels.ssd.ops import ssd_chunked
from repro_torch.kernels.ssd.ref import ssd_chunked_ref
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init

Params = dict


def ssm_dims(cfg: ModelConfig) -> tuple[int, int, int, int]:
    """(d_inner, n_heads, head_dim, d_state)."""
    d_inner = cfg.ssm_expand * cfg.d_model
    return d_inner, d_inner // cfg.ssm_headdim, cfg.ssm_headdim, cfg.ssm_state


def init_ssd(generator: torch.Generator, cfg: ModelConfig) -> Params:
    d_inner, H, P, N = ssm_dims(cfg)
    G = cfg.ssm_ngroups
    conv_dim = d_inner + 2 * G * N
    dev = generator.device
    conv_w = torch.empty((cfg.conv_kernel, conv_dim), device=dev).normal_(generator=generator)
    return {
        "in_proj": dense_init(generator, cfg.d_model, (2 * d_inner + 2 * G * N + H,)),
        "conv_w": 0.1 * conv_w,
        "conv_b": torch.zeros((conv_dim,), device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, device=dev)),
        "D": torch.ones((H,), device=dev),
        "dt_bias": torch.full((H,), float(np.log(np.expm1(0.01))), device=dev),  # softplus⁻¹(0.01)
        "norm_scale": torch.ones((d_inner,), device=dev),
        "out_proj": dense_init(generator, d_inner, (cfg.d_model,)),
    }


def _split_in_proj(cfg: ModelConfig, proj: torch.Tensor):
    d_inner, H, P, N = ssm_dims(cfg)
    G = cfg.ssm_ngroups
    return torch.split(proj, [d_inner, d_inner + 2 * G * N, proj.shape[-1] - 2 * d_inner - 2 * G * N],
                       dim=-1)


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor, tail: torch.Tensor | None):
    """Depthwise causal conv; `tail` is the (k-1)-step history for decode/resume."""
    k = w.shape[0]
    if tail is None:
        pad = xBC.new_zeros((xBC.shape[0], k - 1, xBC.shape[2]))
    else:
        pad = tail.to(xBC.dtype)
    xp = torch.cat([pad, xBC], dim=1)  # (B, T+k-1, C)
    T = xBC.shape[1]
    out = sum(xp[:, i:i + T, :] * w[i].to(xBC.dtype) for i in range(k))
    new_tail = xp[:, -(k - 1):, :] if k > 1 else torch.zeros_like(pad)
    return F.silu(out + b.to(xBC.dtype)), new_tail


def _decode_step(xh, Bm, Cm, dt, a, state0):
    """One recurrent step: (y (B, H, P) f32, state (B, H, P, N))."""
    upd = torch.einsum("bgn,bhp,bh->bhpn", Bm.float(), xh.float(), dt)
    state = state0 * a[:, :, None, None] + upd
    return torch.einsum("bgn,bhpn->bhp", Cm.float(), state), state


def ssd_apply(
    params: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    cache: Params | None = None,
) -> tuple[torch.Tensor, Params | None]:
    """Full Mamba2 block: in_proj → conv → SSD → gated norm → out_proj."""
    Bt, T, _ = x.shape
    d_inner, H, P, N = ssm_dims(cfg)
    G = cfg.ssm_ngroups
    proj = x @ params["in_proj"].to(x.dtype)
    z, xBC, dt = _split_in_proj(cfg, proj)
    dt = F.softplus(dt.float() + params["dt_bias"])  # (B, T, H)
    A = -torch.exp(params["A_log"])  # (H,) negative

    conv_tail = cache["conv"] if cache is not None else None
    xBC, new_tail = _causal_conv(xBC, params["conv_w"], params["conv_b"], conv_tail)
    xs, Bm, Cm = torch.split(xBC, [d_inner, G * N, G * N], dim=-1)
    xh = xs.reshape(Bt, T, H, P)
    # the reference takes group 0 and broadcasts it over the heads
    Bm = Bm.reshape(Bt, T, G, N)[:, :, :1]
    Cm = Cm.reshape(Bt, T, G, N)[:, :, :1]
    state0 = cache["state"].float() if cache is not None else None

    if T == 1 and cache is not None:
        # decode: one recurrent step, no chunking; on DTensors each rank's
        # (rows, heads) block (redistribution point "ssd_blocks")
        a = torch.exp(dt[:, 0] * A)  # (B, H)
        y, state = local_blocks("ssd_blocks", _decode_step, xh[:, 0],
                                (Bm[:, 0], Cm[:, 0], dt[:, 0], a, state0), (1, None, None, 1, 1, 1),
                                out_head_dim=(1, 1))
        y = y.to(x.dtype)[:, None]
    else:
        chunk = min(cfg.ssm_chunk, T)
        if T % chunk:
            raise ValueError(f"T={T} must be at most the chunk {cfg.ssm_chunk} or a multiple of it")
        scan = ssd_chunked if cache is not None else ssd_chunked_ref
        y, state = scan(xh, dt, A, Bm, Cm, state0, chunk=chunk)

    y = y + params["D"].to(y.dtype)[None, None, :, None] * xh
    y = y.reshape(Bt, T, d_inner)
    # gated RMSNorm (mamba2)
    y = y * F.silu(z)
    yf = y.float()
    yf = yf * torch.rsqrt(yf.square().mean(-1, keepdim=True) + 1e-6)
    y = (yf * params["norm_scale"]).to(x.dtype)
    out = y @ params["out_proj"].to(x.dtype)

    if cache is None:
        return out, None
    cache["conv"].copy_(new_tail)
    cache["state"].copy_(state)
    return out, {"conv": cache["conv"], "state": cache["state"], "pos": cache["pos"] + T}


def init_ssd_cache(cfg: ModelConfig, batch: int, n_layers: int, dtype=torch.float32,
                   device=None) -> Params:
    d_inner, H, P, N = ssm_dims(cfg)
    conv_dim = d_inner + 2 * cfg.ssm_ngroups * N
    return {
        "conv": torch.zeros((n_layers, batch, cfg.conv_kernel - 1, conv_dim), dtype=dtype,
                            device=device),
        "state": torch.zeros((n_layers, batch, H, P, N), dtype=dtype, device=device),
        "pos": torch.zeros((), dtype=torch.int32),
    }
