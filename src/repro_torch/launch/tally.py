"""What one step costs a device, counted as it runs: the dry run's
counter (:mod:`repro_torch.launch.dryrun`), also run on a real step to
hold the dry run to it.

:class:`StepTally` is a ``TorchDispatchMode`` that sees the ops a rank
runs on its own tensors: it returns ``NotImplemented`` for an op on a
DTensor, so that DTensor first turns the op into the local op, and the
collectives it needs, which then come back through the mode. The ops
that DTensor's sharding propagation runs on global-shape fake tensors
(under a fake mode of its own) are skipped, so nothing at a global shape
is counted. It counts:

  flops        each op's FLOPs by the flop counter's formulas
               (``torch.utils.flop_counter``, which the port's
               segment_matmul and fused kernel register theirs with), on
               the local shapes;
  collectives  each functional (``_c10d_functional``) and c10d
               collective once, by its output bytes, under the
               reference's five kinds (an all-gather that
               :func:`~repro_torch.distributed.collectives.route_all_gather`
               runs as c10d's counts once: the routed call runs inside the
               mode's own handler, which the mode does not see);
  kernels      calls of the port's kernel ops (``repro_torch::*``);
  memory       (``memory=True``) the bytes of every storage the rank's ops
               allocate, while it lives, on top of the resident state that
               :meth:`StepTally.resident` registers; the peak and what the
               live bytes were at the peak, by category.
"""
from __future__ import annotations

import collections
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["COLLECTIVE_KINDS", "StepTally"]

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute")

# op name (namespace::name, no overload) -> the reference's kind
_KIND = {}
for _ns, _names, _kind in (
        ("_c10d_functional", ("all_reduce", "all_reduce_",
                              "all_reduce_coalesced", "all_reduce_coalesced_"),
         "all-reduce"),
        ("_c10d_functional", ("all_gather_into_tensor",
                              "all_gather_into_tensor_out",
                              "all_gather_into_tensor_coalesced"),
         "all-gather"),
        ("_c10d_functional", ("reduce_scatter_tensor",
                              "reduce_scatter_tensor_out",
                              "reduce_scatter_tensor_coalesced"),
         "reduce-scatter"),
        ("_c10d_functional", ("all_to_all_single",), "all-to-all"),
        ("_c10d_functional_autograd", ("all_gather_into_tensor",),
         "all-gather"),
        ("_c10d_functional_autograd", ("reduce_scatter_tensor",),
         "reduce-scatter"),
        ("_c10d_functional_autograd", ("all_to_all_single",), "all-to-all"),
        ("_dtensor", ("shard_dim_alltoall",), "all-to-all"),
        ("c10d", ("allreduce_", "allreduce_coalesced_"), "all-reduce"),
        ("c10d", ("allgather_", "_allgather_base_",
                  "allgather_into_tensor_coalesced_"), "all-gather"),
        ("c10d", ("reduce_scatter_", "_reduce_scatter_base_",
                  "reduce_scatter_tensor_coalesced_"), "reduce-scatter"),
        ("c10d", ("alltoall_", "alltoall_base_"), "all-to-all"),
        ("c10d", ("send", "recv_"), "collective-permute")):
    for _n in _names:
        _KIND[f"{_ns}::{_n}"] = _kind

CATEGORIES = ("params", "optimizer", "grads", "cache", "activations")


def _tensors(tree):
    out = []
    torch.utils._pytree.tree_map_only(torch.Tensor, out.append, tree)
    return out


def _local(t):
    """A DTensor's local tensor, else ``t``."""
    from torch.distributed.tensor import DTensor
    return t._local_tensor if isinstance(t, DTensor) else t


def _output_bytes(out) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(out))


def _in_propagation() -> bool:
    """Whether DTensor's sharding propagation is running: it computes an
    op's output metadata by running the op on global-shape fake tensors,
    under a fake mode of its own on a real trace but under the trace's own
    fake mode on a fake one, so the caller's frames tell it apart."""
    import sys
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith("sharding_prop.py"):
            return True
        f = f.f_back
    return False


def _wait_op():
    return torch.ops._c10d_functional.wait_tensor.default


class StepTally(TorchDispatchMode):
    """``with StepTally() as t: step(...)``; then ``t.flops``,
    :meth:`collectives`, ``t.kernels`` and, with ``memory=True``,
    :meth:`memory`."""

    def __init__(self, memory: bool = False):
        super().__init__()
        self.flops = 0
        self.kernels: collections.Counter = collections.Counter()
        self.coll_bytes = dict.fromkeys(COLLECTIVE_KINDS, 0)
        self.coll_counts = dict.fromkeys(COLLECTIVE_KINDS, 0)
        self.track_memory = memory
        self._live: dict = {}          # storage key -> [bytes, category]
        self._by_cat = dict.fromkeys(CATEGORIES, 0)
        self.peak = 0
        self.peak_by_cat = dict(self._by_cat)
        self.largest = 0               # the largest one storage held
        self._fake = None

    # -- the mode -------------------------------------------------------
    def __enter__(self):
        from torch._guards import active_fake_mode
        self._fake = active_fake_mode()
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._guards import active_fake_mode
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented        # DTensor desugars first
        kwargs = kwargs or {}
        if func is _wait_op() and self._fake is not None:
            # a fake wait_tensor makes a new tensor; a real one returns
            # its input
            out = args[0]
        else:
            out = func(*args, **kwargs)
        if active_fake_mode() is not self._fake or _in_propagation():
            return out                   # DTensor's sharding propagation
        self._count(func, out, args, kwargs)
        return out

    def _count(self, func, out, args, kwargs) -> None:
        from torch.utils.flop_counter import flop_registry
        packet = func._overloadpacket
        name = func.name().split(".")[0]
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        kind = _KIND.get(name)
        if kind is not None:
            self.coll_counts[kind] += 1
            self.coll_bytes[kind] += self._collective_bytes(func, out, args)
        if name.startswith("repro_torch::"):
            self.kernels[name.split("::")[1]] += 1
        if self.track_memory and func is not _wait_op():
            cat = None
            if kind is not None:
                # a collective of gradients gives gradients
                cats = {self._category(t) for t in _tensors(args)}
                cat = "grads" if "grads" in cats else None
            for t in _tensors(out):
                self._track(t, cat or "activations")

    @staticmethod
    def _collective_bytes(func, out, args) -> int:
        name = func.name().split(".")[0]
        if name.startswith("c10d::"):
            # in-place c10d ops: the first argument is (a list of) the
            # output tensor(s); the returned tuple also holds a Work
            return _output_bytes(args[0])
        return _output_bytes(out)

    # -- memory ---------------------------------------------------------
    @staticmethod
    def _key(t):
        return t.untyped_storage()._cdata

    def _category(self, t):
        rec = self._live.get(self._key(_local(t)))
        return rec[1] if rec else None

    def _track(self, t, category: str) -> None:
        t = _local(t)
        if t.device.type == "meta":
            return                       # no storage anywhere
        st = t.untyped_storage()
        key = st._cdata
        rec = self._live.get(key)
        if rec is not None:
            if rec[1] != category and category != "activations":
                self._by_cat[rec[1]] -= rec[0]
                self._by_cat[category] += rec[0]
                rec[1] = category
            return
        nbytes = st.nbytes()
        self.largest = max(self.largest, nbytes)
        self._live[key] = [nbytes, category]
        self._by_cat[category] += nbytes
        weakref.finalize(st, self._free, key)
        total = sum(self._by_cat.values())
        if total > self.peak:
            self.peak = total
            self.peak_by_cat = dict(self._by_cat)

    def _free(self, key) -> None:
        rec = self._live.pop(key, None)
        if rec is not None:
            self._by_cat[rec[1]] -= rec[0]

    def resident(self, tree, category: str) -> None:
        """Count the tensors of ``tree`` (DTensors by their local tensors)
        as held before the step, under ``category``."""
        for t in _tensors(tree):
            self._track(t, category)

    def grads_of(self, params: dict) -> list:
        """Hooks that count each gradient autograd delivers for a tensor
        of ``params`` as "grads"; returns their handles."""
        def hook(g):
            self._track(g, "grads")
        return [p.register_hook(hook) for p in params.values()
                if p.requires_grad]

    # -- results --------------------------------------------------------
    def collectives(self) -> dict:
        """The reference's ``collective_bytes`` record: ``{"bytes": {kind:
        B}, "counts": {kind: n}, "total_bytes": B}``."""
        return {"bytes": dict(self.coll_bytes),
                "counts": dict(self.coll_counts),
                "total_bytes": sum(self.coll_bytes.values())}

    def memory(self) -> dict:
        """The peak bytes of the rank, what was live at the peak, and the
        largest one storage it held."""
        return {"peak_bytes": self.peak,
                "at_peak": dict(self.peak_by_cat),
                "largest_bytes": self.largest}
