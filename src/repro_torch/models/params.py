"""Carrying parameters across from the reference package.

The JAX models keep each layer as a dict of ``(d_in, d_out)`` arrays
(``y = x @ w``); the port keeps the same layout in its ``nn.Module``s, so
loading is a copy, not a transpose.
"""
from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.device import resolve_device
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


def _value(leaf):
    """The array of a reference parameter leaf (a ``P`` carries it in
    ``.value``; a plain array is its own)."""
    return np.asarray(getattr(leaf, "value", leaf))


def _moment(leaf, device):
    """A reference moment leaf as the port's: an int8 ``QTensor`` (``q``,
    ``scale``) or an fp32 / bf16 array."""
    from repro_torch.optim.adamw import QTensor
    leaf = getattr(leaf, "value", leaf)
    if hasattr(leaf, "q") and hasattr(leaf, "scale"):
        return QTensor(torch.from_numpy(np.array(leaf.q)).to(device),
                       torch.from_numpy(np.array(leaf.scale)).to(device))
    return _tensor(np.asarray(leaf), device)


def _tensor(arr: np.ndarray, device) -> torch.Tensor:
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def from_jax_state(family: str, state, device=None):
    """The port's :class:`~repro_torch.train.trainer.TrainState` from the
    reference's (``repro.train.TrainState``: a list of layer dicts of
    parameters, an ``AdamWState`` of moments shaped alike, the step and a
    PRNG key), read as numpy, with its tensors on ``device`` (``None``:
    the card, raising without one; ``"cpu"`` for the plain versions).
    Parameter names follow the port's ``named_parameters()``
    (``layers.<i>.<name>``). The JAX key has no torch counterpart: the
    generator is seeded from its bits."""
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.train.trainer import TrainState
    if family not in LAYER_PARAMS:
        raise ValueError(f"unknown model {family!r}")
    device = resolve_device(device, "from_jax_state")

    def named(tree, convert):
        return {f"layers.{i}.{name}": convert(lay[name])
                for i, lay in enumerate(tree) for name in LAYER_PARAMS[family]}

    params = named(state.params, lambda p: _tensor(_value(p), device)
                   .requires_grad_())
    opt = state.opt_state
    opt_state = AdamWState(int(np.asarray(opt.step)),
                           named(opt.mu, lambda m: _moment(m, device)),
                           named(opt.nu, lambda m: _moment(m, device)))
    seed = int.from_bytes(np.asarray(state.rng).tobytes()[:8], "little")
    return TrainState(params, opt_state, int(np.asarray(state.step)),
                      torch.Generator().manual_seed(seed % 2 ** 62)
                      .get_state())
