from arks_tpu_torch.engine.engine import EngineConfig, InferenceEngine
from arks_tpu_torch.engine.types import Request, RequestOutput, SamplingParams

__all__ = ["EngineConfig", "InferenceEngine", "Request", "RequestOutput",
           "SamplingParams"]
