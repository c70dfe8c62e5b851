"""The paper's primary contribution over ``torch.distributed`` (port of
``repro/core``):

grid            the ("pod", "data") process groups and staged collectives
hfreduce        hierarchical (pod-aware) all-reduce schedules
tree_allreduce  double-binary-tree / ring collectives over isend / irecv
bucketing       HaiScale-DDP gradient buckets (overlap units)
ddp             the DDP train step with HFReduce sync and ZeRO-1
compression     bf16 / fp8 / int8 (+error feedback) weak-link wire formats
"""
from repro_torch.core.grid import Grid
from repro_torch.core.hfreduce import (crosspod_bytes_flat,
                                       crosspod_bytes_hier, flat_allreduce,
                                       hfreduce, hfreduce_pytree,
                                       hfreduce_tree)
from repro_torch.core.tree_allreduce import ring_allreduce, tree_allreduce

__all__ = ["Grid", "hfreduce", "hfreduce_tree", "hfreduce_pytree",
           "flat_allreduce", "tree_allreduce", "ring_allreduce",
           "crosspod_bytes_flat", "crosspod_bytes_hier"]
