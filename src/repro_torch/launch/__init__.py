"""Launchers: mesh construction and the MCTM training and serving drivers."""
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh

__all__ = ["make_host_mesh", "make_production_mesh"]
