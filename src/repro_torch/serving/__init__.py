"""Paged-KV serving (port of ``repro/serving``): continuous batching
over the paged chunk-attention kernel, speculative decoding, the
prefill/decode-disaggregated cluster and its 3FS prefix store."""
from repro_torch.serving.cluster import ClusterRequest, ServingCluster
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.paged_cache import PagedKVCache
from repro_torch.serving.prefix_store import FS3PrefixStore
from repro_torch.serving.speculative import (SPEC_MODES, DraftModelDrafter,
                                             NGramDrafter, make_drafter)
from repro_torch.serving.stats import SHARED_KEYS, check_schema, serving_stats

__all__ = ["ClusterRequest", "DraftModelDrafter", "FS3PrefixStore",
           "NGramDrafter", "PagedKVCache", "Request", "SHARED_KEYS",
           "SPEC_MODES", "ServingCluster", "ServingEngine", "check_schema",
           "make_drafter", "serving_stats"]
