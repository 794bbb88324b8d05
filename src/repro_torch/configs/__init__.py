from repro_torch.configs.base import (  # noqa: F401
    ArchConfig, DSAConfig, get_config, reduced,
)
