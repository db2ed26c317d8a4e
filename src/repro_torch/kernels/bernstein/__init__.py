from repro_torch.kernels.bernstein.ops import bernstein_basis_deriv, bernstein_featurize

__all__ = ["bernstein_featurize", "bernstein_basis_deriv"]
