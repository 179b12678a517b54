"""Command-line drivers (``python -m repro_torch.launch.serve``,
``python -m repro_torch.launch.train``, ``python -m
repro_torch.launch.dryrun``), mesh construction
(:mod:`repro_torch.launch.mesh`) and the dry run on fake ranks
(:mod:`repro_torch.launch.dryrun`, counted by
:class:`~repro_torch.launch.tally.StepTally`), loaded on first use."""
import importlib

from repro_torch.launch.mesh import make_host_mesh, make_production_mesh

__all__ = ["make_host_mesh", "make_production_mesh", "dryrun", "StepTally"]


def __getattr__(name):
    if name == "dryrun":
        return importlib.import_module("repro_torch.launch.dryrun")
    if name == "StepTally":
        return importlib.import_module("repro_torch.launch.tally").StepTally
    raise AttributeError(f"module 'repro_torch.launch' has no attribute "
                         f"{name!r}")
