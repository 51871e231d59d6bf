"""Architecture configs (one per assigned arch) + shape cells."""
from repro_torch.configs.base import (ModelConfig, ShapeConfig, SHAPES,
                                      ARCH_IDS, get_arch, get_smoke)
