from repro_torch.kernels.extremes.ops import directional_extremes
from repro_torch.kernels.extremes.ref import directional_extremes_ref

__all__ = ["directional_extremes", "directional_extremes_ref"]
