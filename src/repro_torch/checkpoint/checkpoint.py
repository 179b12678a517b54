"""Atomic checkpointing of a tree of tensors (the trainer's state).

Layout, as the reference's (``repro/checkpoint/checkpoint.py``):
``<dir>/step_<N>/`` holding one ``*.npy`` file a leaf plus
``MANIFEST.json``. Leaves are written into ``.tmp-step_<N>``, the
manifest last, then the directory is renamed, so a crash mid-save never
leaves a directory that :func:`latest_step` picks up. ``save_async``
copies the tree to host memory at once and writes on a background thread.

A tree is nested dicts, lists, tuples and NamedTuples whose leaves are
tensors, numpy arrays or Python numbers. bf16 tensors go to disk as their
uint16 bits, with the dtype in the manifest. :func:`restore` reads into
the structure of a target tree and puts each leaf on the target leaf's
device and dtype (a tensor that requires grad is restored as one).

A DTensor leaf (sharded training, :mod:`repro_torch.distributed.step`) is
written whole, gathered from its shards, so every rank of its mesh calls
:func:`save` alike; restored onto a DTensor target it is placed back on the
target's mesh and placements. ``restore(shardings=)`` places each leaf on a
given mesh and placements instead (:class:`Sharding`), so that a state
saved under one mesh restores under another (the elastic restart).
"""
from __future__ import annotations

import hashlib
import json
import pathlib
import re
import shutil
import dataclasses
import threading
from typing import Any, Callable, Optional

import numpy as np
import torch

_STEP_RE = re.compile(r"^step_(\d+)$")


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _items(tree):
    """(key, child) pairs of a container, or None for a leaf."""
    if isinstance(tree, dict):
        return [(f"[{k!r}]", v) for k, v in tree.items()]
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(tree)]
    return None


def _flatten(tree, prefix: str = ""):
    items = _items(tree)
    if items is None:
        return [(prefix, tree)]
    out = []
    for key, child in items:
        out.extend(_flatten(child, prefix + key))
    return out


def _map(fn: Callable, tree, prefix: str = ""):
    """The tree with each leaf replaced by ``fn(key, leaf)``."""
    items = _items(tree)
    if items is None:
        return fn(prefix, tree)
    vals = [_map(fn, child, prefix + key) for key, child in items]
    if isinstance(tree, dict):
        return type(tree)(zip(tree.keys(), vals))
    if _is_namedtuple(tree):
        return type(tree)(*vals)
    return type(tree)(vals)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Where :func:`restore` puts a leaf: a ``DeviceMesh`` and one DTensor
    placement a mesh dim."""
    mesh: Any
    placements: tuple


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered whole (a collective: every rank of its mesh
    calls it); a plain tensor as it is."""
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _to_host(leaf):
    """(numpy array, dtype name) of a leaf; bf16 as its uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = _whole(leaf.detach()).cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.dtype).replace("torch.", "")
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _host_copy(leaf):
    """A snapshot of a leaf that later updates of the leaf cannot change."""
    if isinstance(leaf, torch.Tensor):
        return _whole(leaf.detach()).to("cpu", copy=True)
    return np.array(leaf, copy=True) if isinstance(leaf, np.ndarray) else leaf


def save(tree: Any, directory, step: int,
         keep: Optional[int] = None) -> pathlib.Path:
    """Synchronous atomic save. Returns the final step directory."""
    directory = pathlib.Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    tmp = directory / f".tmp-step_{step}"
    final = directory / f"step_{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    manifest = {"step": step, "leaves": []}
    for key, leaf in _flatten(tree):
        arr, dtype = _to_host(leaf)
        fname = hashlib.sha1(key.encode()).hexdigest()[:20] + ".npy"
        np.save(tmp / fname, arr)
        manifest["leaves"].append({"key": key, "file": fname,
                                   "shape": list(arr.shape), "dtype": dtype})
    (tmp / "MANIFEST.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    if keep is not None:
        _retain(directory, keep)
    return final


_PENDING: list = []


def save_async(tree: Any, directory, step: int,
               keep: Optional[int] = None) -> threading.Thread:
    """Snapshot to host now, write in the background."""
    host_tree = _map(lambda _, leaf: _host_copy(leaf), tree)
    th = threading.Thread(target=save, args=(host_tree, directory, step, keep),
                          daemon=True)
    th.start()
    _PENDING.append(th)
    return th


def wait_pending() -> None:
    for th in _PENDING:
        th.join()
    _PENDING.clear()


def latest_step(directory, at_or_before: Optional[int] = None) -> Optional[int]:
    """Newest complete checkpoint step, or None. ``at_or_before`` bounds the
    answer (the newest step ``<=`` it): the failure-recovery path must
    never restore a checkpoint newer than its failed step."""
    directory = pathlib.Path(directory)
    if not directory.exists():
        return None
    steps = []
    for child in directory.iterdir():
        m = _STEP_RE.match(child.name)
        if m and (child / "MANIFEST.json").exists():
            s = int(m.group(1))
            if at_or_before is None or s <= at_or_before:
                steps.append(s)
    return max(steps) if steps else None


def _from_host(arr: np.ndarray, dtype: str, target, key: str,
               sharding: Optional[Sharding] = None):
    expect = tuple(getattr(target, "shape", arr.shape))
    if tuple(arr.shape) != expect:
        raise ValueError(
            f"leaf {key}: checkpoint shape {arr.shape} != target {expect}")
    if sharding is None and hasattr(target, "device_mesh"):
        sharding = Sharding(target.device_mesh, tuple(target.placements))
    if isinstance(target, torch.Tensor) or sharding is not None:
        t = (torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
             if dtype == "bfloat16" else torch.from_numpy(arr))
        grad = getattr(target, "requires_grad", False)
        if isinstance(target, torch.Tensor):
            t = t.to(dtype=target.dtype)
        if sharding is not None:
            from repro_torch.distributed.sharding import place_tensor
            t = place_tensor(t.to(sharding.mesh.device_type), sharding.mesh,
                             list(sharding.placements))
        else:
            t = t.to(device=target.device)
        return t.requires_grad_(grad)
    if isinstance(target, np.ndarray):
        return arr.astype(target.dtype)
    if isinstance(target, (bool, int, float)):
        return type(target)(arr.item())
    return arr


def restore(target_tree: Any, directory, step: Optional[int] = None,
            shardings: Any = None) -> Any:
    """Restore into the structure of ``target_tree``; each leaf takes the
    target leaf's type, device and dtype (a DTensor target: its mesh and
    placements). ``shardings``: one :class:`Sharding` for every leaf, or a
    tree of them keyed as the target (a leaf it lacks is restored as its
    target says), for an elastic restore onto a new mesh."""
    directory = pathlib.Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    d = directory / f"step_{step}"
    manifest = json.loads((d / "MANIFEST.json").read_text())
    by_key = {leaf["key"]: leaf for leaf in manifest["leaves"]}
    if shardings is None or isinstance(shardings, Sharding):
        placed = {}
    else:
        placed = dict(_flatten(shardings))

    def load(key, target):
        if key not in by_key:
            raise KeyError(f"checkpoint {d} missing leaf {key}")
        entry = by_key[key]
        sh = shardings if isinstance(shardings, Sharding) \
            else placed.get(key)
        return _from_host(np.load(d / entry["file"]), entry["dtype"],
                          target, key, sh)
    return _map(load, target_tree)


def _retain(directory: pathlib.Path, keep: int) -> None:
    steps = sorted(
        int(_STEP_RE.match(c.name).group(1))
        for c in directory.iterdir()
        if _STEP_RE.match(c.name) and (c / "MANIFEST.json").exists())
    for s in steps[:-keep]:
        shutil.rmtree(directory / f"step_{s}", ignore_errors=True)
