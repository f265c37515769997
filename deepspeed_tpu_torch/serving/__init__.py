"""Serving tier of the port: request lifecycle, admission scheduling,
metrics and the threaded ``LLMServer`` over ``InferenceEngineV2``."""

from .metrics import LatencyHistogram, ServingMetrics
from .request import (FINISH_CANCELLED, FINISH_EOS, FINISH_FAILED,
                      FINISH_LENGTH, Request, ServedResponse)
from .scheduler import POLICIES, ContinuousBatchScheduler
from .server import LLMServer, ServerClosed, ServerOverloaded

__all__ = ["LatencyHistogram", "ServingMetrics", "Request", "ServedResponse",
           "FINISH_CANCELLED", "FINISH_EOS", "FINISH_FAILED", "FINISH_LENGTH",
           "POLICIES", "ContinuousBatchScheduler", "LLMServer",
           "ServerClosed", "ServerOverloaded"]
