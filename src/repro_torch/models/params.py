"""Carrying parameters across from the reference package.

The JAX models keep each layer as a dict of ``(d_in, d_out)`` arrays
(``y = x @ w``); the port keeps the same layout in its ``nn.Module``s, so
loading is a copy, not a transpose.
"""
from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.models.gnn import GNN

# the parameter names of each family, in the order of its layer dicts
LAYER_PARAMS = {
    "gcn": ("w", "b"),
    "gin": ("mlp1", "mlp2", "b1", "b2", "eps"),
    "sage": ("w_self", "w_neigh", "b"),
    "gat": ("w", "a_src", "a_dst"),
}

# the parameter whose shape gives a layer's (d_in, ...) and its d_out
_IN_PARAM = {"gcn": "w", "gin": "mlp1", "sage": "w_self", "gat": "w"}


def _layer_dims(family: str, layer: Mapping[str, np.ndarray]):
    d_in = int(np.shape(layer[_IN_PARAM[family]])[0])
    if family == "gat":
        heads, d_out = np.shape(layer["a_src"])
        return d_in, int(d_out), int(heads)
    return d_in, int(np.shape(layer[_IN_PARAM[family]])[1]), 1


def from_jax_params(family: str,
                    layers: Sequence[Mapping[str, np.ndarray]]) -> GNN:
    """A :class:`GNN` holding the reference's weights.

    ``layers`` is one dict per layer mapping each parameter name (``w``,
    ``b``, ``mlp1``, ``mlp2``, ``b1``, ``b2``, ``eps``, ``w_self``,
    ``w_neigh``, ``a_src``, ``a_dst``) to an ndarray — e.g.
    ``[{k: np.asarray(p.value) for k, p in lay.items()} for lay in
    repro.models.gnn.init(...)]``."""
    if family not in LAYER_PARAMS:
        raise ValueError(f"unknown model {family!r}")
    if not layers:
        raise ValueError("from_jax_params needs at least one layer")
    dims, heads = [], 1
    for lay in layers:
        d_in, d_out, heads = _layer_dims(family, lay)
        if dims and dims[-1] != d_in:
            raise ValueError(f"layer widths do not chain: {dims[-1]} -> {d_in}")
        dims = dims or [d_in]
        dims.append(d_out)
    np_dtype = np.asarray(layers[0][_IN_PARAM[family]]).dtype
    dtype = torch.from_numpy(np.zeros(0, np_dtype)).dtype
    model = GNN(family, dims, heads=heads, dtype=dtype)
    with torch.no_grad():
        for module, lay in zip(model.layers, layers):
            for name in LAYER_PARAMS[family]:
                p = getattr(module, name)
                value = torch.from_numpy(np.array(lay[name], copy=True))
                if tuple(value.shape) != tuple(p.shape):
                    raise ValueError(f"{family} parameter {name}: shape "
                                     f"{tuple(value.shape)} != {tuple(p.shape)}")
                p.copy_(value.to(p.dtype))
    return model
