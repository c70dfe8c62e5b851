from repro_torch.configs.base import (ModelConfig, MoEConfig, SSMConfig,
                                ShapeConfig, ParallelConfig, SHAPES,
                                applicable_shapes)

__all__ = [
    "ModelConfig", "MoEConfig", "SSMConfig", "ShapeConfig", "ParallelConfig",
    "SHAPES", "applicable_shapes",
]
