from arks_tpu_torch.server.openai_server import OpenAIServer

__all__ = ["OpenAIServer"]
