from repro_torch.configs.base import (
    ARCH_NAMES,
    SHAPES,
    ArchConfig,
    MoEConfig,
    ShapeConfig,
    applicable_shapes,
    get_config,
    get_shape,
    list_configs,
    reduced,
)

__all__ = [
    "ARCH_NAMES",
    "SHAPES",
    "ArchConfig",
    "MoEConfig",
    "ShapeConfig",
    "applicable_shapes",
    "get_config",
    "get_shape",
    "list_configs",
    "reduced",
]
