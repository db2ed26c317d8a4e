from repro_torch.kernels.sweep.ops import fused_sweep_update

__all__ = ["fused_sweep_update"]
