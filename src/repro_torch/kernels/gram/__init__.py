from repro_torch.kernels.gram.ops import gram_matrix

__all__ = ["gram_matrix"]
