"""repro_torch — the GeoT reproduction ported to PyTorch and CUDA on an
NVIDIA H100 (Hopper, sm_90a).

This package serves 3-layer GCN / GIN / GraphSAGE / multi-head GAT node
classification, runs relation-typed RGCN / RGAT inference, trains every
family (``fit``: AdamW, checkpoints, resume; every op's backward runs on
the same kernels) on full graphs or on sampled mini-batches (a neighbour
sampler and a prefetch pipeline feeding the card), serves and trains the
homogeneous families sharded across ranks of ``torch.distributed`` (one
process a shard: ``GNNServer(shards=S)``, ``fit(mesh=...)``), serves the
ten LM architectures of ``repro_torch.configs`` (``models.lm``: prefill and
decode against KV / recurrent caches, MoE experts on segment_matmul and
their combine on the gather kernel; ``serve.lm.ContinuousBatcher``,
``python -m repro_torch.launch.serve``), trains them on one device
(``train.LMTask`` behind ``fit``: the expert products and their dX on
segment_matmul, the embedding's backward on segment_reduce; ``python -m
repro_torch.launch.train``), reports through a
metrics registry, spans and build attribution (``obs``), and offers the
library's public segment ops. Each plan's kernel config (the run length
and tile the kernels read) is selected from the graph's O(1) features by
generated decision-tree rules, or measured on the card (``tune=True``,
kept in a PerfDB). Six
hand-written CUDA kernels carry it: ``gather_segment_reduce`` (every
aggregation), ``segment_softmax`` (attention), ``fused_transform_reduce``
(SpMM + GEMM in one launch), ``segment_matmul`` (the per-relation
transforms of a typed layer as one grouped launch), ``segment_reduce`` and
``sddmm`` (the public ops). Each sits beside a plain PyTorch version of the
same function; CPU tensors take the plain version, CUDA tensors the kernel
(built with ``nvcc`` on first use). Plans and models are built on the card
unless the caller passes ``device="cpu"``.

    import repro_torch as rt

    model = rt.gnn_init("gcn", 32, 64, 16, seed=0)
    server = rt.GNNServer(model, "gcn")            # on the card
    server.submit(rt.dataset("ogbn-arxiv"))
    (result,) = server.step(flush=True)

    y = rt.segment_reduce(x, idx, num_segments, "mean")   # x, idx on the card

    data = rt.GraphEpochProvider(shapes=((96, 384), (128, 512)))
    task = rt.NodeClassification.from_provider(data, model="gcn")
    result = rt.fit(task, data, rt.TrainerConfig(steps=50))   # on the card

    # sampled mini-batches: a neighbour sampler behind the prefetch pipeline
    with rt.SampledNodeProvider(rt.dataset("ogbn-arxiv"),
                                fanouts=(15, 10, 5), batch_size=1024,
                                plan_feat=64) as data:
        task = rt.NodeClassification.from_provider(data, model="sage")
        result = rt.fit(task, data, rt.TrainerConfig(steps=50))
    print(rt.obs.report())         # counters, histograms, build causes

    # sharded, one process a rank (after init_process_group on each)
    mesh = rt.make_shard_mesh(4)
    server = rt.GNNServer(model, "gcn", shards=4, mesh=mesh)
    result = rt.fit(task, data, rt.TrainerConfig(steps=50), mesh=mesh)

The JAX package ``repro`` is the reference this port is tested against;
this package imports neither it nor JAX.
"""
from repro_torch import obs
from repro_torch.core.config_space import KernelConfig, default_config
from repro_torch.core.dist_mp import (ShardMesh, make_shard_mesh, mp_sharded,
                                      mp_transform_sharded,
                                      segment_softmax_sharded)
from repro_torch.core.heuristics import select_config, select_plan_config
from repro_torch.core.mp import choose_order, mp, mp_transform, mp_typed
from repro_torch.core.ops import (
    fused_transform_reduce,
    gather,
    grouped_segment_matmul,
    index_segment_reduce,
    index_weight_segment_reduce,
    sddmm,
    segment_matmul,
    segment_reduce,
    segment_softmax,
)
from repro_torch.core.plan import (
    PartitionedPlan,
    RelationPlan,
    SegmentPlan,
    make_graph_plan,
    make_partitioned_plan,
    make_plan,
    make_relation_plan,
)
from repro_torch.data.graphs import (
    Graph,
    TypedGraph,
    batch_graphs,
    dataset,
    pad_graph,
    synth_graph,
    synth_typed_graph,
)
from repro_torch.data.partition import (PartitionedGraph, partition_graph,
                                        unpartition_edges, unpartition_nodes)
from repro_torch.data.pipeline import PrefetchPipeline, SampledBatchProducer
from repro_torch.data.sampling import (InMemoryStore, NeighborSampler,
                                       ShardedGraphStore, save_graph_shards)
from repro_torch.kernels.ops import launch_counts, reset_launch_counts
from repro_torch.models.gnn import GNN, MODELS, TYPED_MODELS
from repro_torch.models.gnn import forward as gnn_forward
from repro_torch.models.gnn import init as gnn_init
from repro_torch.models.params import from_jax_params
from repro_torch.serve import GNNServer
from repro_torch.train import (GraphEpochProvider, NodeClassification,
                               SampledNodeProvider, Trainer, TrainerConfig,
                               TrainState, fit)

__all__ = [
    # graphs
    "Graph", "TypedGraph", "synth_graph", "synth_typed_graph", "dataset",
    "batch_graphs", "pad_graph",
    # plans + config
    "SegmentPlan", "RelationPlan", "make_plan", "make_graph_plan",
    "make_relation_plan", "KernelConfig", "default_config", "select_config",
    "select_plan_config",
    # ops + message passing
    "segment_reduce", "gather", "sddmm", "grouped_segment_matmul",
    "segment_matmul", "index_segment_reduce", "index_weight_segment_reduce",
    "fused_transform_reduce", "segment_softmax", "mp", "mp_transform",
    "mp_typed", "choose_order",
    # kernel launch accounting
    "launch_counts", "reset_launch_counts",
    # models + serving
    "GNN", "MODELS", "TYPED_MODELS", "gnn_init", "gnn_forward", "from_jax_params",
    "GNNServer",
    # training
    "GraphEpochProvider", "NodeClassification", "Trainer", "TrainerConfig",
    "TrainState", "fit",
    # sampled mini-batches
    "NeighborSampler", "InMemoryStore", "ShardedGraphStore",
    "save_graph_shards", "SampledBatchProducer", "PrefetchPipeline",
    "SampledNodeProvider",
    # sharded message passing
    "PartitionedGraph", "partition_graph", "unpartition_nodes",
    "unpartition_edges", "PartitionedPlan", "make_partitioned_plan",
    "ShardMesh", "make_shard_mesh", "mp_sharded", "mp_transform_sharded",
    "segment_softmax_sharded",
    # telemetry
    "obs",
]
