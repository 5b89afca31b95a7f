"""Epoch-keyed snapshot cache — exact invalidation, no TTLs.

The streaming miner's ``epoch`` counter (see
:attr:`repro_torch.core.streaming.StreamingMiner.epoch`) bumps exactly when the
closed prefix — and therefore the snapshot — can change.  Caching query
state keyed on that epoch makes repeated queries between finalizations free
(no re-mine) while staying provably fresh: a stale entry cannot be served
because the key itself is the consistency token.

The cache is deliberately tiny: sessions only ever query the newest epoch,
so ``capacity`` is a small LRU bound that tolerates a reader briefly holding
an older engine, not a memory pool.
"""

from __future__ import annotations

from collections import OrderedDict


class EpochCache:
    """Small LRU mapping ``epoch -> value`` with hit/miss accounting."""

    def __init__(self, capacity: int = 2):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self._entries: OrderedDict[int, object] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, epoch: int):
        """Return the cached value for ``epoch`` or ``None`` (and count it)."""
        try:
            value = self._entries[epoch]
        except KeyError:
            self.misses += 1
            return None
        self._entries.move_to_end(epoch)
        self.hits += 1
        return value

    def peek(self, epoch: int):
        """Uncounted lookup (no hit/miss, no LRU bump).

        The compare-and-swap re-check after a lock-free snapshot mine:
        the racing reader already paid (and recorded) its miss, so the
        re-check must not double-count or reorder the LRU.
        """
        return self._entries.get(epoch)

    def put(self, epoch: int, value) -> None:
        self._entries[epoch] = value
        self._entries.move_to_end(epoch)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.evictions += 1

    def stats(self) -> dict[str, int]:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "entries": len(self._entries),
        }
