"""Paged-KV serving: continuous batching over the paged chunk-attention
kernel (port of ``repro/serving`` without speculation, the cluster or
the 3FS prefix store)."""
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.paged_cache import PagedKVCache
from repro_torch.serving.stats import SHARED_KEYS, check_schema, serving_stats

__all__ = ["PagedKVCache", "Request", "SHARED_KEYS", "ServingEngine",
           "check_schema", "serving_stats"]
