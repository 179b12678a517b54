"""GNN inference serving: buckets, plan cache, batcher, engine."""
from repro_torch.serve.batcher import GraphBatcher, GraphRequest
from repro_torch.serve.buckets import (BucketPolicy, ShapeBucket, bucket_for,
                                       bucket_rungs, bucket_size, pad_to_bucket)
from repro_torch.serve.engine import GNNServer, ServedResult
from repro_torch.serve.plan_cache import (BucketEntry, CacheStats, PlanCache,
                                          measured_config)

__all__ = ["GraphBatcher", "GraphRequest", "BucketPolicy", "ShapeBucket",
           "bucket_for", "bucket_rungs", "bucket_size", "pad_to_bucket",
           "GNNServer", "ServedResult", "BucketEntry", "CacheStats",
           "PlanCache", "measured_config"]
