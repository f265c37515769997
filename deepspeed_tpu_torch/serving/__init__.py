"""Serving tier of the port: request lifecycle, admission scheduling,
metrics, the threaded ``LLMServer`` over ``InferenceEngineV2``, replica
routing with heartbeat takeover, and open-loop traffic."""

from .metrics import LatencyHistogram, ServingMetrics, TenantStats
from .replica import ReplicaRouter
from .request import (FINISH_CANCELLED, FINISH_EOS, FINISH_FAILED,
                      FINISH_LENGTH, Request, ServedResponse)
from .scheduler import POLICIES, ContinuousBatchScheduler
from .server import LLMServer, ServerClosed, ServerOverloaded
from .traffic import LengthDist, OpenLoopTraffic, TrafficConfig

__all__ = ["LatencyHistogram", "ServingMetrics", "TenantStats", "Request",
           "ServedResponse", "FINISH_CANCELLED", "FINISH_EOS", "FINISH_FAILED",
           "FINISH_LENGTH", "POLICIES", "ContinuousBatchScheduler", "LLMServer",
           "ServerClosed", "ServerOverloaded", "ReplicaRouter", "LengthDist",
           "OpenLoopTraffic", "TrafficConfig"]
