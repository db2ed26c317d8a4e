from repro_torch.data.dgp import DGP_NAMES, DGPS, generate

__all__ = ["DGPS", "DGP_NAMES", "generate"]
