"""Command-line drivers (``python -m repro_torch.launch.serve``,
``python -m repro_torch.launch.train``) and mesh construction
(:mod:`repro_torch.launch.mesh`)."""
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh

__all__ = ["make_host_mesh", "make_production_mesh"]
