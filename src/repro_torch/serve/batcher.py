"""Iteration-level micro-batching for graph requests.

Queued requests are admitted FIFO into **block-diagonal** batches — one
:func:`repro_torch.data.graphs.batch_graphs` call per batch, so one kernel
launch aggregates every member graph at once — under

  * a **size budget** (``max_batch_nodes`` / ``max_batch_edges``): the
    block-diagonal batch's |V| and |E| are what the padded forward pays
    for (a request alone over budget is still admitted as a singleton — it
    must be servable);
  * a **count cap** (``max_batch_graphs``); and
  * a **latency deadline** (``max_wait_s``): an under-budget batch is held
    back for more traffic until its oldest member has waited this long.
    ``max_wait_s=0`` (default) serves whatever is queued each step.

Admission is counted in the :mod:`repro_torch.obs` registry
(``serve.submitted``, ``serve.queue_depth``; optional instruments: nothing
in the serving contract reads them back).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, List, Optional

from repro_torch import obs
from repro_torch.data.graphs import Graph

__all__ = ["GraphRequest", "GraphBatcher"]


@dataclasses.dataclass
class GraphRequest:
    """One queued inference request."""
    uid: int
    graph: Graph
    t_submit: float = dataclasses.field(default_factory=time.perf_counter)


class GraphBatcher:
    """FIFO admission into block-diagonal batches under budget + deadline."""

    def __init__(self, max_batch_nodes: int = 4096,
                 max_batch_edges: Optional[int] = None,
                 max_batch_graphs: int = 16,
                 max_wait_s: float = 0.0):
        if max_batch_nodes < 1 or max_batch_graphs < 1:
            raise ValueError("batch budgets must be >= 1")
        self.max_batch_nodes = int(max_batch_nodes)
        self.max_batch_edges = (None if max_batch_edges is None
                                else int(max_batch_edges))
        self.max_batch_graphs = int(max_batch_graphs)
        self.max_wait_s = float(max_wait_s)
        self.queue: Deque[GraphRequest] = deque()
        reg = obs.get_registry()
        self._labels = {"batcher": obs.next_id("batcher")}
        self._m_submitted = reg.counter("serve.submitted", ("batcher",))
        self._m_depth = reg.gauge("serve.queue_depth", ("batcher",))
        self._m_submitted.touch(**self._labels)
        self._m_depth.touch(**self._labels)

    def __len__(self) -> int:
        return len(self.queue)

    def submit(self, req: GraphRequest) -> None:
        self.queue.append(req)
        self._m_submitted.inc(**self._labels)
        self._m_depth.set(len(self.queue), **self._labels)

    def _fits(self, req: GraphRequest, nodes: int, edges: int,
              count: int) -> bool:
        if count >= self.max_batch_graphs:
            return False
        if count and nodes + req.graph.num_nodes > self.max_batch_nodes:
            return False            # count==0: oversize singleton is allowed
        if (count and self.max_batch_edges is not None
                and edges + req.graph.num_edges > self.max_batch_edges):
            return False
        return True

    def _budget_full(self, nodes: int, edges: int, count: int) -> bool:
        """Would the next queued request NOT fit?"""
        return bool(self.queue) and not self._fits(self.queue[0], nodes,
                                                   edges, count)

    def next_batch(self, now: Optional[float] = None,
                   flush: bool = False) -> List[GraphRequest]:
        """Admit the next batch, or [] when it pays to wait.

        A batch is released when it is budget-full, when its oldest member
        has waited ``max_wait_s``, or when ``flush`` forces a drain."""
        if not self.queue:
            return []
        now = time.perf_counter() if now is None else now
        deadline_hit = (flush or
                        now - self.queue[0].t_submit >= self.max_wait_s)
        batch: List[GraphRequest] = []
        nodes = edges = 0
        while self.queue and self._fits(self.queue[0], nodes, edges,
                                        len(batch)):
            req = self.queue.popleft()
            batch.append(req)
            nodes += req.graph.num_nodes
            edges += req.graph.num_edges
        # a batch at the count cap is full even with an empty queue: holding
        # it for the deadline would be pure added latency
        full = (len(batch) >= self.max_batch_graphs
                or self._budget_full(nodes, edges, len(batch)))
        if not deadline_hit and not full:
            for req in reversed(batch):
                self.queue.appendleft(req)
            return []
        self._m_depth.set(len(self.queue), **self._labels)
        return batch
