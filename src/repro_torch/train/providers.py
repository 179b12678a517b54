"""Dataset providers: the ``DatasetProvider`` leg of the training protocol
(``DatasetProvider → Task → Trainer``), as the reference's
(``repro/train/providers.py``).

A provider's one method, ``batch(step)``, is deterministic in the step
index: the same step always yields the same batch, with no iterator state
to carry through checkpoints. The fault-tolerant loop relies on it: after
a failure it restores the newest complete checkpoint and replays the steps
since.

Graph providers keep their epoch of graphs as persistent objects, so the
per-graph plan memo (:meth:`repro_torch.data.graphs.Graph.make_plan`)
survives across steps: a shape's plan is built once.

Not ported yet: the sampled mini-batch provider (ROADMAP Queue A item 4)
and the token provider of the LM task (item 7).
"""
from __future__ import annotations

from typing import Any, Protocol, runtime_checkable

from repro_torch.data.graphs import (batch_graphs, synth_graph,
                                     synth_typed_graph)

__all__ = ["DatasetProvider", "GraphEpochProvider"]


@runtime_checkable
class DatasetProvider(Protocol):
    """Anything with a deterministic ``batch(step)`` is a provider."""

    def batch(self, step: int) -> Any:                 # pragma: no cover
        ...


class GraphEpochProvider:
    """Synthetic graph epochs for node-classification training.

    Builds a fixed pool of power-law graphs at the distinct ``(|V|, |E|)``
    ``shapes`` (the same graphs as the reference's provider for the same
    arguments), optionally block-diagonally batched ``graphs_per_batch`` at
    a time, and cycles through the epoch: ``batch(step) =
    epoch[step % len(epoch)]``. ``typed=True`` yields
    :class:`~repro_torch.data.graphs.TypedGraph` members for RGCN/RGAT
    (not batched: batching would drop the edge types)."""

    def __init__(self, shapes=((96, 384), (128, 512)),
                 graphs_per_shape: int = 2, graphs_per_batch: int = 1,
                 feat: int = 32, num_classes: int = 16, typed: bool = False,
                 num_relations: int = 4, alpha: float = 1.3, seed: int = 0,
                 name: str = "train"):
        if typed and graphs_per_batch != 1:
            raise ValueError("typed graphs cannot be block-diagonally "
                             "batched (edge types would be dropped); use "
                             "graphs_per_batch=1")
        if graphs_per_shape % graphs_per_batch:
            raise ValueError("graphs_per_shape must be a multiple of "
                             "graphs_per_batch")
        self.feat = feat
        self.num_classes = num_classes
        self.num_relations = num_relations if typed else 0
        self.typed = typed
        epoch = []
        for si, (v, e) in enumerate(shapes):
            members = []
            for j in range(graphs_per_shape):
                s = seed * 9973 + si * 97 + j
                if typed:
                    members.append(synth_typed_graph(
                        f"{name}-{v}x{e}-{j}", v, e,
                        num_relations=num_relations, feat=feat,
                        num_classes=num_classes, alpha=alpha, seed=s))
                else:
                    members.append(synth_graph(
                        f"{name}-{v}x{e}-{j}", v, e, feat=feat,
                        num_classes=num_classes, alpha=alpha, seed=s))
            for k in range(0, len(members), graphs_per_batch):
                chunk = members[k:k + graphs_per_batch]
                epoch.append(chunk[0] if len(chunk) == 1
                             else batch_graphs(chunk))
        self._epoch = epoch

    def __len__(self) -> int:
        """Steps per epoch (distinct batches before the cycle repeats)."""
        return len(self._epoch)

    def batch(self, step: int):
        return self._epoch[step % len(self._epoch)]
