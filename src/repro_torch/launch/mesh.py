"""Mesh construction on ``torch.distributed``, the port of
``repro/launch/mesh.py``: a ``DeviceMesh`` over the initialised world
with named dims.

Functions, not module-level constants: importing this module touches no
process group. The caller (a launcher such as ``torchrun``, or a test's
spawned ranks) initialises ``torch.distributed`` first; a mesh whose size
is not the world's raises, as ``jax.make_mesh`` does with the wrong
number of devices. The mesh is on the card (``"cuda"``) unless the
caller asks for ``device_type="cpu"``. Ranks that share one card run on
gloo (NCCL takes one card a rank); their functional all-gathers are then
routed through c10d's (:func:`repro_torch.distributed.collectives.
route_all_gather`).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

__all__ = ["make_host_mesh", "make_production_mesh"]


def _make_mesh(shape: Sequence[int], names: Sequence[str],
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` with dim names ``names`` over every
    rank of the initialised world (rank r at row-major position r)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "a mesh needs torch.distributed initialised (launch with "
            "torchrun, or call init_process_group first)")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a {tuple(shape)} mesh needs {math.prod(shape)} "
                         f"ranks; the world has {world}")
    if device_type == "cuda" and dist.get_backend() == "gloo":
        # ranks sharing one card: gloo's functional all-gather of CUDA
        # tensors runs as c10d's (see route_all_gather)
        from repro_torch.distributed.collectives import route_all_gather
        route_all_gather("CUDA")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16×16 = 256 ranks a pod; 2 pods = 512 ranks multi-pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, names, device_type)


def make_host_mesh(data: int = 2, model: int = 2, pipe: Optional[int] = None,
                   device_type: str = "cuda"):
    """A small ("data", "model"[, "pipe"]) mesh for tests and one host."""
    if pipe:
        return _make_mesh((data, model, pipe), ("data", "model", "pipe"),
                         device_type)
    return _make_mesh((data, model), ("data", "model"), device_type)
