"""Phase 2 — overlap-aware signed aggregation (sort + segment-sum).

The paper deduplicates boundary-zone candidates with hash sets and an atomic
global merge.  Here Lemma 4.2 is used directly: count every zone
independently and give growth zones weight +1, boundary zones weight -1.  The
signed sum over identical codes *is* the inclusion-exclusion reconciliation
``|G| = sum|G_i| - sum|B_i|`` — no hashing, fully vectorized:

  1. flatten (zone, candidate) -> one stream of (code limbs, weight);
  2. lexicographic sort by limbs: limbs are non-negative 28-bit values, so
     each pair of limbs packs into one int64 key, and stable sorts chained
     from the last key to the first give the exact limb-lexicographic order
     (one key up to ``l_max = 7``, two up to the 4-bit digit limit);
  3. group boundaries by adjacent-difference; each group's last row,
     found by a binary search over the group ids, gives its code and the
     difference of an int64 prefix sum of the weights gives its count:
     one writer per output row, no atomics, the same bytes on every run.

Every table is static-shape: rows are the compacted sorted unique codes,
then zero rows.  Invalid slots carry the all-zero code (sorts first) with
weight 0, and that padding group stays masked.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_LIMB_BITS = 28


class CodeCounts(NamedTuple):
    """Sorted unique codes with (possibly signed-cancelled) counts.

    ``codes`` int32[N, L] — row i is meaningful where ``unique_mask[i]``;
    ``counts`` int32[N]   — aligned with codes;
    ``unique_mask`` bool[N].
    The all-zero padding code, if present, is masked out.
    """

    codes: torch.Tensor
    counts: torch.Tensor
    unique_mask: torch.Tensor


def empty_counts(capacity: int, limbs: int, *, device=None) -> CodeCounts:
    """An all-padding count table (the identity element of merging)."""
    return CodeCounts(
        codes=torch.zeros((capacity, limbs), dtype=torch.int32,
                          device=device),
        counts=torch.zeros((capacity,), dtype=torch.int32, device=device),
        unique_mask=torch.zeros((capacity,), dtype=torch.bool, device=device),
    )


def _lex_order(codes) -> torch.Tensor:
    """Row permutation sorting ``codes[N, L]`` limb-lexicographically."""
    n, limbs = codes.shape
    wide = codes.to(torch.int64)
    keys = []
    for i in range(0, limbs, 2):
        key = wide[:, i]
        if i + 1 < limbs:
            key = (key << _LIMB_BITS) | wide[:, i + 1]
        keys.append(key)
    perm = None
    for key in reversed(keys):
        if perm is not None:
            key = key[perm]
        order = torch.sort(key, stable=True).indices
        perm = order if perm is None else perm[order]
    return perm


def count_codes(codes, weights) -> CodeCounts:
    """Signed counting of code rows.

    Args:
      codes:   int32[N, L] limb codes (all-zero rows = padding).
      weights: int32[N] signed weights (0 for padding).
    """
    n, limbs = codes.shape
    dev = codes.device
    if n == 0:
        return empty_counts(0, limbs, device=dev)
    perm = _lex_order(codes)
    sorted_codes = codes[perm]
    sorted_w = weights[perm].to(torch.int32)

    boundary = torch.ones(n, dtype=torch.bool, device=dev)
    boundary[1:] = (sorted_codes[1:] != sorted_codes[:-1]).any(dim=1)
    gid = torch.cumsum(boundary, dim=0) - 1
    n_unique = gid[-1] + 1

    # Each output row is read once from its group's last sorted row: no
    # atomics (the padding group would serialise on one address) and no
    # duplicate writes.  Past the last group every end is row n - 1, so
    # those counts difference to 0 by themselves.
    idx = torch.arange(n, device=dev)
    ends = torch.searchsorted(gid, idx, right=True) - 1
    csum = torch.cumsum(sorted_w, dim=0, dtype=torch.int64)[ends]
    counts = torch.diff(csum, prepend=csum.new_zeros(1))
    counts = counts.to(torch.int32)      # wraps as an int32 segment sum
    live = idx < n_unique
    unique_codes = torch.where(live[:, None], sorted_codes[ends], 0)
    unique_mask = live & (unique_codes != 0).any(dim=1)
    return CodeCounts(codes=unique_codes, counts=counts,
                      unique_mask=unique_mask)


def aggregate_zones(zone_codes, zone_lengths, zone_signs) -> CodeCounts:
    """Flatten a [Z, C, L] zone-result batch and signed-count it.

    Args:
      zone_codes:   int32[Z, C, L] final candidate codes.
      zone_lengths: int32[Z, C] process lengths (0 = padding slot).
      zone_signs:   int32[Z] +1 growth / -1 boundary / 0 padded zone row.
    """
    z, c, limbs = zone_codes.shape
    flat_codes = zone_codes.reshape(z * c, limbs)
    signs = zone_signs.to(torch.int32)[:, None]
    flat_w = ((zone_lengths > 0).to(torch.int32) * signs).reshape(z * c)
    flat_codes = torch.where(flat_w[:, None] != 0, flat_codes, 0)
    return count_codes(flat_codes, flat_w)


def _masked(c: CodeCounts):
    return (torch.where(c.unique_mask[:, None], c.codes, 0),
            torch.where(c.unique_mask, c.counts, 0))


def merge_counts(a: CodeCounts, b: CodeCounts) -> CodeCounts:
    """Merge two (e.g. per-device) count maps into one."""
    a_codes, a_counts = _masked(a)
    b_codes, b_counts = _masked(b)
    return count_codes(torch.cat([a_codes, b_codes]),
                       torch.cat([a_counts, b_counts]))


def live_rows(c: CodeCounts):
    """(codes, counts) with dead rows zeroed.

    A row is live when it is a unique code whose signed count has not fully
    cancelled.  Cancelled rows (count 0) are semantically absent but still
    occupy table slots after :func:`count_codes`; zeroing their codes lets
    the next merge reclaim the capacity — they collapse into the all-zero
    padding group instead of holding a bounded-width carry slot forever.
    """
    live = c.unique_mask & (c.counts != 0)
    return (torch.where(live[:, None], c.codes, 0),
            torch.where(live, c.counts, 0))


def merge_bounded(a: CodeCounts, b: CodeCounts, *, cap: int):
    """Merge ``b`` into ``a``, bounding the result to ``cap`` rows.

    The carry primitive of the on-device fold: partial per-chunk count
    tables fold through a fixed-capacity table so peak memory is
    O(cap + len(b)) instead of O(total candidates).  Unique codes compact
    to the front sorted, so truncating to ``cap`` rows is exact whenever
    the live-unique population fits.

    Returns ``(merged, spilled)`` where ``spilled`` (an int32 scalar
    tensor, left on the device) is the number of live unique codes that
    did NOT fit in ``cap`` rows.  ``spilled > 0`` means the result is
    inexact and the caller must re-run with a larger cap (the executor's
    spill policy doubles ``merge_cap`` and retries — exact overflow
    detection makes the retry loop lossless).
    """
    a_codes, a_counts = live_rows(a)
    b_codes, b_counts = live_rows(b)
    merged = count_codes(torch.cat([a_codes, b_codes]),
                         torch.cat([a_counts, b_counts]))
    live = merged.unique_mask & (merged.counts != 0)
    spilled = live[cap:].sum(dtype=torch.int32)
    total = merged.counts.shape[0]
    if total >= cap:
        out = CodeCounts(codes=merged.codes[:cap], counts=merged.counts[:cap],
                         unique_mask=merged.unique_mask[:cap])
    else:
        pad = empty_counts(cap - total, merged.codes.shape[1],
                           device=merged.codes.device)
        out = CodeCounts(*(torch.cat([m, p]) for m, p in zip(merged, pad)))
    return out, spilled
