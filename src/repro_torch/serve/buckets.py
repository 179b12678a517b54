"""Shape buckets: pad variable-shape graphs onto a fixed ladder of
(num_nodes, num_edges) classes so a stream of arbitrary graphs is served
by a bounded set of cache entries.

Bucketing rounds (V, E) up a geometric ladder (power-of-two by default)
and pads the graph to the bucket with
:func:`repro_torch.data.graphs.pad_graph`:

  * padded **edges** carry ``dst = V_bucket`` — the drop id the kernels
    skip — so they fall outside every output window and real-node logits
    are identical to the unpadded graph under the same kernel config;
  * padded **nodes** are isolated; their output rows are sliced away by
    ``unpad_nodes``.

The number of distinct buckets a workload can touch is O(log² of its
shape range).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.data.graphs import Graph, pad_graph

__all__ = ["ShapeBucket", "BucketPolicy", "bucket_size", "bucket_rungs",
           "bucket_for", "pad_to_bucket"]


@dataclasses.dataclass(frozen=True, order=True)
class ShapeBucket:
    """One shape class: graphs are padded to exactly this (V, E)."""
    num_nodes: int
    num_edges: int

    def __str__(self) -> str:
        return f"V{self.num_nodes}xE{self.num_edges}"


@dataclasses.dataclass(frozen=True)
class BucketPolicy:
    """The bucket ladder: floors and a geometric growth factor.

    ``growth=2.0`` (default) is the power-of-two ladder — at most 2x node
    and edge padding waste. A finer ``growth`` trades more cache entries
    for less padded work; coarser floors merge micro-graphs into one bucket.
    """
    min_nodes: int = 64
    min_edges: int = 64
    growth: float = 2.0

    def __post_init__(self):
        if self.growth <= 1.0:
            raise ValueError(f"growth must be > 1, got {self.growth}")
        if self.min_nodes < 1 or self.min_edges < 1:
            raise ValueError("bucket floors must be >= 1")


def bucket_size(n: int, floor: int, growth: float = 2.0) -> int:
    """Smallest rung of the ladder ``floor * growth^k`` that is >= n."""
    size = int(floor)
    while size < n:
        size = max(int(size * growth), size + 1)
    return size


def bucket_rungs(hi: int, floor: int, growth: float = 2.0) -> list:
    """Every ladder rung up to (and including) ``bucket_size(hi)``."""
    sizes, size = [], int(floor)
    while True:
        sizes.append(size)
        if size >= hi:
            return sizes
        size = max(int(size * growth), size + 1)


def bucket_for(num_nodes: int, num_edges: int,
               policy: Optional[BucketPolicy] = None) -> ShapeBucket:
    """The shape class of a (V, E) graph under ``policy``."""
    policy = policy or BucketPolicy()
    return ShapeBucket(
        num_nodes=bucket_size(num_nodes, policy.min_nodes, policy.growth),
        num_edges=bucket_size(num_edges, policy.min_edges, policy.growth),
    )


def pad_to_bucket(g: Graph, policy: Optional[BucketPolicy] = None,
                  bucket: Optional[ShapeBucket] = None,
                  ) -> Tuple[Graph, ShapeBucket]:
    """Pad ``g`` to its bucket (or an explicit one); returns (padded,
    bucket). Round-trip with ``unpad_nodes`` / ``unpad_graph``."""
    if bucket is None:
        bucket = bucket_for(g.num_nodes, g.num_edges, policy)
    return pad_graph(g, bucket.num_nodes, bucket.num_edges), bucket
