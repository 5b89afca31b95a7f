"""Motif analytics service — multi-tenant serving over streaming discovery.

Layers (bottom up):

* :mod:`.query`   — :class:`QueryEngine`: analytics over one immutable
  snapshot (top-k, Table-6 transition probabilities, O(log n) prefix counts
  via the limb encoding's integer-lexicographic order, level histogram).
* :mod:`.cache`   — :class:`EpochCache`: snapshot cache keyed on the
  miner's closed-prefix epoch; invalidation is exact, never TTL-based.
* :mod:`.session` — :class:`MotifSession`: one tenant's StreamingMiner
  behind batched-ingest admission and the cache.
* :mod:`.manager` — :class:`SessionManager`: named multi-tenant registry.
* :mod:`.service` — :class:`MotifService`: dataclass request/response
  protocol; the surface transports and drivers talk to.
"""

from .cache import EpochCache
from .manager import SessionManager
from .query import QueryEngine, TransitionRow
from .service import (
    QUERY_OPS,
    IngestAck,
    MotifService,
    QueryRequest,
    QueryResponse,
)
from .session import MotifSession

__all__ = [
    "EpochCache",
    "IngestAck",
    "MotifService",
    "MotifSession",
    "QUERY_OPS",
    "QueryEngine",
    "QueryRequest",
    "QueryResponse",
    "SessionManager",
    "TransitionRow",
]
