from repro_torch.optim.optimizers import (
    Optimizer,
    adafactor,
    adamw,
    apply_updates,
    chain,
    clip_by_global_norm,
    lion,
    scale_updates,
    sgd,
)
from repro_torch.optim.schedules import constant, cosine_warmup, linear_warmup

__all__ = ["Optimizer", "adamw", "adafactor", "lion", "sgd", "chain", "clip_by_global_norm",
           "apply_updates", "scale_updates", "constant", "cosine_warmup", "linear_warmup"]
