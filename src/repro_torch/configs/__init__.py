from repro_torch.configs.base import (  # noqa: F401
    ArchConfig,
    ShapeConfig,
    SHAPES,
    get_config,
    list_archs,
    smoke_config,
)
