"""Elastic fault-tolerant training (port of ``repro/elastic``; paper
§VI-C/§VII, DESIGN.md §13): plan-stamped sharded checkpoints,
cross-plan resharding, and the async 3FS-backed save pipeline that
keeps writes off the training critical path."""
from repro_torch.elastic.manifest import (MANIFEST_NAME, build_manifest,
                                          master_layout, mesh_to_dict,
                                          plan_from_dict, plan_to_dict,
                                          plans_equal)
from repro_torch.elastic.reshard import canonical_state, reshard
from repro_torch.elastic.sharded import (ElasticCheckpointer,
                                         PlanMismatchError, save_sharded,
                                         snapshot_sharded)

__all__ = [
    "MANIFEST_NAME",
    "ElasticCheckpointer",
    "PlanMismatchError",
    "build_manifest",
    "canonical_state",
    "master_layout",
    "mesh_to_dict",
    "plan_from_dict",
    "plan_to_dict",
    "plans_equal",
    "reshard",
    "save_sharded",
    "snapshot_sharded",
]
