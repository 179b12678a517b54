"""Parameters: the LM's seeded initialisers and containers, and carrying
parameters across from the reference package.

The JAX models keep each layer as a dict of ``(d_in, d_out)`` arrays
(``y = x @ w``); the port keeps the same layout in its ``nn.Module``s, so
loading is a copy, not a transpose. The LM's parameter dicts become
:class:`Params` modules with the same keys (``from_jax_lm_params``).

Every LM parameter carries the reference's logical axes ("embed", "mlp",
"heads", "kv", "vocab", "expert", …; one name or None a dim): an
initialiser returns a :class:`P` (tensor + axes), :class:`Params` keeps
the axes of its tensors in ``.axes`` and :func:`param_axes` reads a whole
model's. :mod:`repro_torch.distributed.sharding` maps them onto the mesh.
The port keeps one module a layer, so its axes are the reference's
``effective_axes`` (no leading "layers").
"""
from __future__ import annotations

import math
from typing import Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.core.device import resolve_device
from repro_torch.models.gnn import GNN


# ---------------------------------------------------------------------------
# the LM's parameter dicts and initialisers
# ---------------------------------------------------------------------------

class P(NamedTuple):
    """A parameter as an initialiser makes it: the tensor and its logical
    axes (the reference's ``P`` leaf)."""
    value: torch.Tensor
    axes: Tuple[Optional[str], ...]


class Params(nn.Module):
    """One parameter dict of the reference's LM tree as a module: each key
    an attribute, a tensor (registered as a frozen ``nn.Parameter``, so
    that serving builds no autograd graph) or a sub-dict (a module).
    ``"key" in params`` and :meth:`keys` read it as the dict it mirrors.
    A :class:`P` item registers its tensor and keeps its axes in
    ``self.axes[key]`` (a bare tensor gets all-None axes: replicated).
    Training does not unfreeze them: :class:`~repro_torch.train.task.LMTask`
    trains a flat ``{name: tensor}`` dict of leaves that require grad,
    bound to a meta-device skeleton by ``torch.func.functional_call``."""

    def __init__(self, **items):
        super().__init__()
        self.axes = {}
        for name, value in items.items():
            if isinstance(value, nn.Module):
                self.add_module(name, value)
                continue
            value, axes = value if isinstance(value, P) else (value, None)
            self.axes[name] = (tuple(axes) if axes is not None
                               else (None,) * value.dim())
            if len(self.axes[name]) != value.dim():
                raise ValueError(f"{name}: axes {self.axes[name]} for a "
                                 f"{value.dim()}-d tensor")
            self.register_parameter(
                name, nn.Parameter(value, requires_grad=False))

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def keys(self):
        return list(self._parameters) + list(self._modules)


def normal(gen: Optional[torch.Generator], shape, dtype, device,
           std: float = 1.0) -> torch.Tensor:
    """``std``·N(0, 1) drawn in ``dtype`` from ``gen`` on ``device``; with
    no generator an uninitialised tensor, for a carrier to fill."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device=device)
    return torch.randn(shape, generator=gen, dtype=dtype,
                       device=device).mul_(std)


def uniform(gen: Optional[torch.Generator], shape, dtype, device):
    """U[0, 1) in ``dtype`` (uninitialised with no generator)."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device=device)
    return torch.rand(shape, generator=gen, dtype=dtype, device=device)


def dense_init(gen, in_dim: int, out_dim: int, axes, dtype, device,
               scale: float = 1.0) -> P:
    """(in_dim, out_dim) weight, N(0, (scale/√in_dim)²), with its logical
    axes, as the reference's ``dense_init``."""
    return P(normal(gen, (in_dim, out_dim), dtype, device,
                    scale / math.sqrt(in_dim)), tuple(axes))


def embed_init(gen, vocab: int, dim: int, dtype, device) -> P:
    """(vocab, dim) table, N(0, 0.02²), on axes ("vocab", "embed")."""
    return P(normal(gen, (vocab, dim), dtype, device, 0.02),
             ("vocab", "embed"))


def zeros_init(shape, axes, dtype, device) -> P:
    return P(torch.zeros(shape, dtype=dtype, device=device), tuple(axes))


def ones_init(shape, axes, dtype, device) -> P:
    return P(torch.ones(shape, dtype=dtype, device=device), tuple(axes))


def param_axes(module: nn.Module) -> dict:
    """``{name: logical axes}`` of every parameter of ``module``, named as
    its ``named_parameters()``."""
    out = {}
    for prefix, sub in module.named_modules():
        for name in getattr(sub, "_parameters", {}):
            axes = getattr(sub, "axes", {}).get(name) if isinstance(
                sub, Params) else None
            p = sub._parameters[name]
            out[f"{prefix}.{name}" if prefix else name] = (
                axes if axes is not None else (None,) * p.dim())
    return out


def generator(seed: Optional[int], device) -> Optional[torch.Generator]:
    """A generator on ``device`` seeded with ``seed`` (None: none, so the
    initialisers leave their tensors uninitialised)."""
    if seed is None:
        return None
    return torch.Generator(device=device).manual_seed(seed)

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


# ---------------------------------------------------------------------------
# the LM
# ---------------------------------------------------------------------------

def _ref_axes(leaf, layer: Optional[tuple]):
    """A reference ``P`` leaf's axes as the port keeps them (a stacked
    period leaf's leading "layers" dropped), or None for a bare array."""
    axes = getattr(leaf, "axes", None)
    if axes is None:
        return None
    axes = tuple(axes)
    return axes[1:] if layer is not None and axes[:1] == ("layers",) \
        else axes


def carry(module, tree, path: str, layer: Optional[tuple] = None) -> None:
    """Copy a reference parameter (sub)tree into ``module``: a dict into a
    :class:`Params` with the same keys, a leaf into its ``nn.Parameter``
    (``layer = (p, n)``: slice p of a leading stacked-layers axis that must
    hold n). Raises on a missing or extra key, on a shape mismatch and on
    a ``P`` leaf whose logical axes differ from the port's."""
    if isinstance(tree, Mapping):
        if not isinstance(module, Params) or set(tree) != set(module.keys()):
            have = sorted(module.keys()) if isinstance(module, Params) else \
                type(module).__name__
            raise ValueError(f"{path}: reference keys {sorted(tree)} != "
                             f"port {have}")
        for key, sub in tree.items():
            want = _ref_axes(sub, layer)
            if want is not None and key in module.axes and \
                    module.axes[key] != want:
                raise ValueError(f"{path}.{key}: reference axes {want} != "
                                 f"the port's {module.axes[key]}")
            carry(getattr(module, key), sub, f"{path}.{key}", layer)
        return
    arr = _value(tree)
    if layer is not None:
        if arr.shape[:1] != (layer[1],):
            raise ValueError(f"{path}: {arr.shape[:1]} stacked layers, the "
                             f"config has {layer[1]}")
        arr = arr[layer[0]]
    if not isinstance(module, torch.Tensor) or \
            tuple(arr.shape) != tuple(module.shape):
        want = tuple(module.shape) if isinstance(module, torch.Tensor) \
            else type(module).__name__
        raise ValueError(f"{path}: shape {tuple(arr.shape)} != {want}")
    with torch.no_grad():
        module.copy_(_tensor(arr, "cpu").to(module.dtype))


def from_jax_lm_params(cfg, tree, device=None):
    """The port's :class:`~repro_torch.models.lm.LM` holding the weights of
    ``repro.models.lm.init(key, cfg)``: ``tree`` is that pytree with each
    leaf as a numpy array (``P.value``) or a ``P``. Each ``"period"`` slot's
    leading layers axis is unstacked into per-layer modules in the
    reference's layer order (layer ``lead + p·period + s`` is slot ``s`` of
    period ``p``); ``lead``, ``embed``, ``lm_head``, ``pos_embed``,
    ``final_norm``, ``enc_blocks``, ``enc_norm`` and ``enc_pos`` carry
    over by name. Every shape is checked; a mismatch or a missing key
    raises. Tensors go to ``device`` (None: the card, raising without one;
    ``"cpu"`` for the plain versions)."""
    from repro_torch.models.lm import LM, stack_plan
    device = resolve_device(device, "from_jax_lm_params")
    lead_kinds, period_kinds, n_periods = stack_plan(cfg)
    dtype = _tensor(_value(tree["embed"]["table"])[:0], "cpu").dtype
    model = LM(cfg, dtype=dtype, device=device, seed=None)
    stacks = {"lead", "period"} | ({"enc_blocks"} if cfg.encoder_layers
                                   else set())
    flat = set(model.keys()) - {"layers", "enc_blocks"}
    if set(tree) != flat | stacks:
        raise ValueError(f"reference keys {sorted(tree)} != the port's LM "
                         f"{sorted(flat | stacks)}")
    for key in sorted(flat):
        want = _ref_axes(tree[key], None)
        if want is not None and key in model.axes and model.axes[key] != want:
            raise ValueError(f"{key}: reference axes {want} != the port's "
                             f"{model.axes[key]}")
        carry(getattr(model, key), tree[key], key)
    if len(tree["lead"]) != len(lead_kinds) or \
            len(tree["period"]) != len(period_kinds):
        raise ValueError(f"reference stack ({len(tree['lead'])} lead, "
                         f"{len(tree['period'])} period slots) != the "
                         f"config's ({len(lead_kinds)}, {len(period_kinds)})")
    for i, sub in enumerate(tree["lead"]):
        carry(model.layers[i], sub, f"lead[{i}]")
    width = len(period_kinds)
    for s, sub in enumerate(tree["period"]):
        for p in range(n_periods):
            carry(model.layers[len(lead_kinds) + p * width + s], sub,
                   f"period[{s}][{p}]", layer=(p, n_periods))
    if len(tree.get("enc_blocks", ())) != cfg.encoder_layers:
        raise ValueError(f"{len(tree['enc_blocks'])} encoder blocks, the "
                         f"config has {cfg.encoder_layers}")
    for i, sub in enumerate(tree.get("enc_blocks", ())):
        carry(model.enc_blocks[i], sub, f"enc_blocks[{i}]")
    return model
