"""Query engine over one immutable :class:`DiscoveryResult` snapshot.

Final-code counts are sufficient statistics for every query the service
answers (see :mod:`repro_torch.core.transitions`), so an engine is built
once per snapshot epoch and all derived indexes — the transition tree and the
integer-lexicographic code index — are materialized lazily and then shared
by every query against that epoch.

``prefix_count`` exploits the limb encoding's ordering guarantee
(:func:`repro_torch.core.encoding.prefix_range_np`): codes sharing a transition
prefix form one contiguous range in integer-lexicographic limb order, so the
count of processes that *reached* a motif is two binary searches over a
sorted byte-key index plus one prefix-sum subtraction — O(log n) per query
instead of a scan over all motif types.
"""

from __future__ import annotations

import bisect
import dataclasses

import numpy as np

from repro_torch.core import encoding, transitions
from repro_torch.core.api import DiscoveryResult


@dataclasses.dataclass(frozen=True)
class TransitionRow:
    """One Table-6 row: an observed next step from a motif and its share."""

    code: str      # child motif code (one edge longer)
    count: int     # processes that reached the child
    share: float   # fraction of the parent's evolved processes


#: Labels are first-occurrence node indices, at most ``l_max`` (paper cap
#: 14), so valid code digits are exactly the hex characters 0..e.
_CODE_ALPHABET = frozenset("0123456789abcde")


def _check_code(code: str, l_max: int) -> bool:
    """Validate structure; return whether the code is observable at all.

    Odd length is a malformed request (two digits per edge) and raises;
    codes outside the label alphabet or longer than ``l_max`` edges are
    well-formed but unobservable — no process can ever carry them — so
    callers treat those as cheap misses (count 0, no rows), not errors.
    """
    if len(code) % 2 != 0:
        raise ValueError(
            f"motif code {code!r} has odd length; transition prefixes "
            "carry two digits per edge"
        )
    return (len(code) <= 2 * l_max
            and all(c in _CODE_ALPHABET for c in code))


class QueryEngine:
    """Read-only analytics over one snapshot; safe to share across readers.

    ``epoch`` is the session epoch the snapshot was mined at — the
    consistency token responses carry.  Lazy index builds race benignly
    under concurrent readers: every build derives the same immutable data
    from the same immutable snapshot.
    """

    def __init__(self, result: DiscoveryResult, epoch: int = 0):
        self.result = result
        self.epoch = epoch
        self._tree: transitions.TransitionTree | None = None
        # assigned as one tuple so concurrent lazy builds stay atomic
        self._index: tuple[list[bytes], np.ndarray] | None = None

    # -- lazily built indexes ----------------------------------------------

    @property
    def tree(self) -> transitions.TransitionTree:
        if self._tree is None:
            self._tree = transitions.build_tree(self.result.counts)
        return self._tree

    def _code_index(self) -> tuple[list[bytes], np.ndarray]:
        index = self._index
        if index is None:
            l_max = self.result.l_max
            rows = sorted(
                (encoding.code_key_np(
                    encoding.encode_label_string_np(code, l_max)), cnt)
                for code, cnt in self.result.counts.items()
            )
            index = ([k for k, _ in rows],
                     np.cumsum([c for _, c in rows], dtype=np.int64))
            self._index = index
        return index

    # -- queries ------------------------------------------------------------

    def top_k_motifs(self, level: int | None = None,
                     k: int = 10) -> list[tuple[str, int]]:
        """Most frequent final motifs, optionally restricted to one level."""
        if k < 1:
            raise ValueError("k must be >= 1")
        items = (
            (code, cnt) for code, cnt in self.result.counts.items()
            if level is None or len(code) // 2 == level
        )
        return sorted(items, key=lambda kv: (-kv[1], kv[0]))[:k]

    def transition_probs(self, code: str = "") -> list[TransitionRow]:
        """Observed next steps from ``code`` (Table 6 as predictions).

        Shares sum to 1 over the rows whenever any process evolved past
        ``code``; an unobserved code yields no rows rather than an error so
        speculative lookups stay cheap for callers.
        """
        if not _check_code(code, self.result.l_max):
            return []
        try:
            node = self.tree.node(code) if code else self.tree.root
        except KeyError:
            return []
        return [TransitionRow(code=c, count=n, share=s)
                for c, n, s in node.transition_rows()]

    def prefix_count(self, code: str = "") -> int:
        """Processes whose transition process passed through ``code``."""
        if not _check_code(code, self.result.l_max):
            return 0
        keys, cum = self._code_index()
        if not keys:
            return 0
        if not code:
            return int(cum[-1])
        lo, hi = encoding.prefix_range_np(code, self.result.l_max)
        i = bisect.bisect_left(keys, encoding.code_key_np(lo))
        j = bisect.bisect_right(keys, encoding.code_key_np(hi))
        if j <= i:
            return 0
        return int(cum[j - 1] - (cum[i - 1] if i else 0))

    def level_histogram(self) -> dict[int, int]:
        return self.result.level_histogram()

    def total_processes(self) -> int:
        return self.result.total_processes()
