from repro_torch.kernels.bernstein.ops import bernstein_featurize

__all__ = ["bernstein_featurize"]
