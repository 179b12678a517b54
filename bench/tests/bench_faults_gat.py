"""Faults planted under the timed path of ``gat-reddit2.infer``, for the
tests that see ``correct`` come out false: each a context manager that
patches the program for as long as it is open. The control, the
program's own TF32 path switched on, is ``bench_faults.tf32``.

* ``heads_averaged``: layer 1 averages its heads where it concatenates
  them, a hidden layer one head wide (256 at the cell's size), repeated
  across the heads' columns so that layer 2 takes it; bias and skip as
  they are.
* ``no_self_loops``: the graph's self-loops never added, so no node
  attends to itself.
"""
from __future__ import annotations

import contextlib

import torch
from bench_faults import patched


@contextlib.contextmanager
def heads_averaged():
    from repro_torch.models import gnn

    def make(forward):
        def run(self, x, *args, **kwargs):
            if self.index != 0 or not self.concat:
                return forward(self, x, *args, **kwargs)
            saved = self.concat, self.b, self.w_skip, self.b_skip
            self.concat, self.b, self.w_skip, self.b_skip = (False, None,
                                                             None, None)
            try:
                mean = forward(self, x, *args, **kwargs)
            finally:
                self.concat, self.b, self.w_skip, self.b_skip = saved
            out = torch.cat([mean] * self.heads, 1)
            if self.b is not None:
                out = out + self.b
            if self.w_skip is not None:
                out = out + x @ self.w_skip + self.b_skip
            return out
        return run
    with patched(gnn.GATLayer, "forward", make):
        yield


@contextlib.contextmanager
def no_self_loops():
    from repro_torch.data import graphs
    with patched(graphs, "add_self_loops",
                 lambda add: lambda edge_index, num_nodes: edge_index):
        yield


GAT_FAULTS = {"heads_averaged": heads_averaged,
              "no_self_loops": no_self_loops}
