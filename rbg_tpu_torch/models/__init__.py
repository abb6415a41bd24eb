"""Model configs, the llama-family forward and the JAX weight bridge."""

from rbg_tpu_torch.models.config import ModelConfig, get_config, list_presets

__all__ = ["ModelConfig", "get_config", "list_presets"]
