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
    "rgcn": ("w_rel", "w_self", "b"),
    "rgat": ("w_rel", "a_src", "a_dst"),
}

# the parameter whose shape gives a layer's d_in (and, but for the
# attention families, its d_out)
_IN_PARAM = {"gcn": "w", "gin": "mlp1", "sage": "w_self", "gat": "w",
             "rgcn": "w_self", "rgat": "w_rel"}


def _layer_dims(family: str, layer: Mapping[str, np.ndarray]):
    """(d_in, d_out, GNN keyword arguments) of one layer dict."""
    shape = np.shape(layer[_IN_PARAM[family]])
    if family == "gat":
        heads, d_out = np.shape(layer["a_src"])
        return int(shape[0]), int(d_out), {"heads": int(heads)}
    if family == "rgat":
        rel, heads, d_out = np.shape(layer["a_src"])
        return int(shape[1]), int(d_out), {"heads": int(heads),
                                           "num_relations": int(rel)}
    if family == "rgcn":
        return int(shape[0]), int(shape[1]), {
            "num_relations": int(np.shape(layer["w_rel"])[0])}
    return int(shape[0]), int(shape[1]), {}


def from_jax_params(family: str,
                    layers: Sequence[Mapping[str, np.ndarray]]) -> GNN:
    """A :class:`GNN` holding the reference's weights.

    ``layers`` is one dict per layer mapping each parameter name (``w``,
    ``b``, ``mlp1``, ``mlp2``, ``b1``, ``b2``, ``eps``, ``w_self``,
    ``w_neigh``, ``a_src``, ``a_dst``, ``w_rel``) to an ndarray: rgcn's
    ``w_rel`` is (R, d_in, d_out); rgat's ``w_rel`` (R, d_in, heads·d_out),
    ``a_src`` (R, heads, d_out) and ``a_dst`` (R, heads, d_in) — e.g.
    ``[{k: np.asarray(p.value) for k, p in lay.items()} for lay in
    repro.models.gnn.init(...)]``."""
    if family not in LAYER_PARAMS:
        raise ValueError(f"unknown model {family!r}")
    if not layers:
        raise ValueError("from_jax_params needs at least one layer")
    dims, kw = [], {}
    for lay in layers:
        d_in, d_out, kw = _layer_dims(family, lay)
        if dims and dims[-1] != d_in:
            raise ValueError(f"layer widths do not chain: {dims[-1]} -> {d_in}")
        dims = dims or [d_in]
        dims.append(d_out)
    np_dtype = np.asarray(layers[0][LAYER_PARAMS[family][0]]).dtype
    dtype = torch.from_numpy(np.zeros(0, np_dtype)).dtype
    model = GNN(family, dims, dtype=dtype, **kw)
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
