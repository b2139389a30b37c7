from repro_torch.configs.base import (ArchConfig, InputShape, INPUT_SHAPES,
                                get_config, get_smoke_config, list_archs)

__all__ = ["ArchConfig", "InputShape", "INPUT_SHAPES", "get_config",
           "get_smoke_config", "list_archs"]
