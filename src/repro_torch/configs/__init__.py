from repro_torch.configs.base import (ArchConfig, LayerSpec, ShapeConfig,
                                      SHAPES, get_config, list_archs)

__all__ = ["ArchConfig", "LayerSpec", "ShapeConfig", "SHAPES", "get_config",
           "list_archs"]
