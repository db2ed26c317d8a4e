"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA device. Asking for CUDA where there is none
    raises — the port never carries on on the CPU unless asked to. On CUDA,
    float32 matrix products are pinned to full float32 (no TF32), as the
    reference computes in f32 end to end."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port's plain PyTorch versions on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def to_tensor(x, dtype=None, device=None) -> torch.Tensor:
    """A tensor on ``device`` from a tensor, a numpy array or anything numpy
    reads (a copy unless ``x`` already is a tensor of that dtype and device)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)
