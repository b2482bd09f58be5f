from arks_tpu_torch.models.config import ModelConfig, get_config, register_config

__all__ = ["ModelConfig", "get_config", "register_config"]
