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

:class:`SampledNodeProvider` is the out-of-core provider: a neighbour
sampler behind the prefetch pipeline. :class:`TokenProvider` feeds the LM
task: numpy token batches, bitwise the reference's for the same config.
"""
from __future__ import annotations

from typing import Any, Protocol, runtime_checkable

from repro_torch.data.graphs import (Graph, batch_graphs, synth_graph,
                                     synth_typed_graph)
from repro_torch.data.pipeline import PrefetchPipeline, SampledBatchProducer
from repro_torch.data.sampling import InMemoryStore, NeighborSampler
from repro_torch.data.tokens import SyntheticTokens, TokenDatasetConfig

__all__ = ["DatasetProvider", "GraphEpochProvider", "SampledNodeProvider",
           "TokenProvider"]


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


class SampledNodeProvider:
    """Out-of-core node-classification batches: a
    :class:`~repro_torch.data.sampling.NeighborSampler` behind the provider
    protocol, with the prefetch pipeline
    (:class:`~repro_torch.data.pipeline.PrefetchPipeline`) doing the host
    work off the critical path, as the reference's.

    ``batch(step)`` returns a
    :class:`~repro_torch.data.pipeline.SampledBatch` on ``device`` (the
    card unless ``device="cpu"``; raising without one);
    :class:`~repro_torch.train.task.NodeClassification` trains on its seed
    rows only (``label_mask``). A batch is a pure function of
    ``(seed, step)`` (prefetch threads change timing, never content), so
    checkpoint replay stays exact.

    ``num_classes`` comes from the store's metadata; ``feat`` is the
    *input* feature width. Pass ``plan_feat`` (the model's widest layer —
    ``NodeClassification.plan_feat``). Call :meth:`close` (or use as a
    context manager) when done — the pipeline owns live threads."""

    def __init__(self, store_or_graph, *, fanouts=(8, 4), batch_size=64,
                 seed_nodes=None, exact=False, seed=0, plan_feat=128,
                 policy=None, cache=None, depth=2, num_threads=None,
                 device=None):
        if isinstance(store_or_graph, Graph):
            store_or_graph = InMemoryStore(store_or_graph)
        self.store = store_or_graph
        self.sampler = NeighborSampler(
            store_or_graph, fanouts, batch_size=batch_size,
            seed_nodes=seed_nodes, exact=exact, seed=seed)
        self.producer = SampledBatchProducer(
            self.sampler, feat=plan_feat, policy=policy, cache=cache,
            device=device)
        self.pipeline = PrefetchPipeline(self.producer, depth=depth,
                                         num_threads=num_threads)
        self.feat = int(self.store.feat)
        self.num_classes = int(self.store.num_classes)
        self.num_relations = 0
        self.typed = False

    def __len__(self) -> int:
        return len(self.sampler)

    def batch(self, step: int):
        return self.pipeline.batch(step)

    def stats(self) -> dict:
        d = self.pipeline.stats()
        d["cache"] = self.producer.cache.stats.as_dict()
        return d

    def close(self) -> None:
        self.pipeline.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class TokenProvider:
    """LM token batches: a provider-protocol wrapper over the deterministic
    :class:`~repro_torch.data.tokens.SyntheticTokens` pipeline (a fixed
    Markov language; each batch is a pure function of ``(seed, step,
    host)``, so checkpoint replay is exact). Batches are numpy
    ``{"tokens", "labels"}`` (int32, this host's rows);
    :class:`~repro_torch.train.task.LMTask` moves them to its device."""

    def __init__(self, cfg: TokenDatasetConfig, host_id: int = 0,
                 num_hosts: int = 1):
        self.cfg = cfg
        self._ds = SyntheticTokens(cfg, host_id=host_id, num_hosts=num_hosts)

    def batch(self, step: int):
        return self._ds.batch(step)
