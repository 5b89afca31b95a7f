"""Motif-transition statistics and the transition tree (reporting layer).

Final-code counts are sufficient statistics for the whole discovery problem:
a process that stopped at code ``c`` passed through every even-length prefix
of ``c``, so per-level transition counts (Fig. 6 / Table 6 of the paper) are
prefix aggregations.  This module is host-side numpy — it renders results,
the device pipeline never depends on it.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict

import numpy as np

from . import encoding


@dataclasses.dataclass
class TransitionNode:
    """One motif type in the transition tree."""

    code: str                     # paper-style label string, e.g. "0101"
    stopped: int = 0              # processes that ended here
    through: int = 0              # processes that reached here (>= stopped)
    children: dict = dataclasses.field(default_factory=dict)

    @property
    def evolved(self) -> int:
        return self.through - self.stopped

    def transition_rows(self):
        """Rows like Table 6: (child code, count, share of evolved)."""
        total = sum(ch.through for ch in self.children.values())
        rows = []
        for code in sorted(self.children):
            ch = self.children[code]
            share = ch.through / total if total else 0.0
            rows.append((code, ch.through, share))
        return rows


class TransitionTree:
    """Trie over motif codes with stopped/through counts."""

    def __init__(self):
        self.root = TransitionNode(code="")

    def add(self, code: str, count: int):
        node = self.root
        node.through += count
        for level in range(2, len(code) + 1, 2):
            prefix = code[:level]
            if prefix not in node.children:
                node.children[prefix] = TransitionNode(code=prefix)
            node = node.children[prefix]
            node.through += count
        node.stopped += count

    def node(self, code: str) -> TransitionNode:
        node = self.root
        for level in range(2, len(code) + 1, 2):
            node = node.children[code[:level]]
        return node

    def render(self, code: str = "", max_depth: int = 2) -> str:
        """ASCII rendering of the transition tree (Fig. 6 analog)."""
        start = self.node(code) if code else self.root
        lines = []

        def walk(node, depth):
            if depth > max_depth:
                return
            for child_code, count, share in node.transition_rows():
                lines.append(
                    f"{'  ' * depth}{child_code}: {count} ({share:.1%})"
                )
                walk(node.children[child_code], depth + 1)

        walk(start, 0)
        return "\n".join(lines)


def counts_to_dict(codes: np.ndarray, counts: np.ndarray,
                   mask: np.ndarray | None = None) -> dict[str, int]:
    """Device count arrays -> {code string: count}, dropping zeros."""
    out: dict[str, int] = defaultdict(int)
    codes = np.asarray(codes)
    counts = np.asarray(counts)
    if mask is None:
        mask = np.ones(counts.shape, bool)
    for row, cnt in zip(codes[np.asarray(mask)], counts[np.asarray(mask)]):
        if cnt == 0:
            continue
        out[encoding.decode_code_np(row)] += int(cnt)
    return {k: v for k, v in out.items() if v != 0}


def device_counts_to_dict(counts) -> dict[str, int]:
    """:class:`~repro_torch.core.aggregation.CodeCounts` of tensors on any
    device -> {code string: count}."""
    host = lambda x: x.detach().cpu().numpy()
    return counts_to_dict(host(counts.codes), host(counts.counts),
                          host(counts.unique_mask))


def build_tree(final_counts: dict[str, int]) -> TransitionTree:
    tree = TransitionTree()
    for code, count in final_counts.items():
        tree.add(code, count)
    return tree


def level_histogram(final_counts: dict[str, int]) -> dict[int, int]:
    """Processes per final length (1..l_max)."""
    hist: dict[int, int] = defaultdict(int)
    for code, count in final_counts.items():
        hist[len(code) // 2] += count
    return dict(hist)
