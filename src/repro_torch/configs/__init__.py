"""Architecture configurations (copies of the JAX package's `configs/`)."""
from repro_torch.configs.registry import ARCHS, get_config, reduced_config

__all__ = ["ARCHS", "get_config", "reduced_config"]
