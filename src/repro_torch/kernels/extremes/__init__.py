from repro_torch.kernels.extremes.ops import directional_extremes

__all__ = ["directional_extremes"]
