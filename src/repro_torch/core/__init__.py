"""The paper's algorithm on PyTorch: TZP, parallel expansion, signed
aggregation, deterministic encoding."""

from . import (
    aggregation,
    backends,
    encoding,
    expansion,
    oracle,
    planner,
    transitions,
    tzp,
)
from .api import DiscoveryResult
from .backends import available_backends, get_backend, register_backend
from .config import MiningConfig
from .engine import EngineStats, PTMTEngine
from .executor import MiningExecutor, ZoneChunkError, ZoneOverflowError
from .streaming import StreamingMiner
from .temporal_graph import TemporalGraph, from_edges

__all__ = [
    "DiscoveryResult",
    "EngineStats",
    "MiningConfig",
    "MiningExecutor",
    "PTMTEngine",
    "StreamingMiner",
    "TemporalGraph",
    "ZoneChunkError",
    "ZoneOverflowError",
    "aggregation",
    "available_backends",
    "backends",
    "encoding",
    "expansion",
    "from_edges",
    "get_backend",
    "oracle",
    "planner",
    "register_backend",
    "transitions",
    "tzp",
]
