from .base import (ARCH_IDS, PORTED_ARCH_IDS, ModelConfig, canonical,
                   get_config)
