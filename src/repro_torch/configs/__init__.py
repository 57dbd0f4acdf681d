"""Architecture configs (the archs the port serves)."""
from repro_torch.configs.base import (  # noqa: F401
    FluxConfig,
    ModelConfig,
    get_config,
    list_configs,
    register,
    smoke_variant,
)

ALL_ARCHS = list_configs()
