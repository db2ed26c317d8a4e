from repro_torch.kernels.ssd.ops import ssd_chunked

__all__ = ["ssd_chunked"]
