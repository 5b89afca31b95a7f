"""The comparison that decides ``correct``: a count table against the
reference's.

Both sides are read as maps from a code to its signed count, with zero
counts dropped: a code whose count cancelled to 0 is absent (Lemma 4.2),
whether a table keeps its row or not.  The number compared is how many
codes the two maps give different counts (absent counting as 0), plus
every duplicate row of the program's table, since a table holds each
code once.
"""

from __future__ import annotations

import numpy as np

from .ptmt_ref import MAX_L_MAX

#: the program's code layout (``repro_torch.core.encoding``, the format of
#: its ``CodeCounts.codes``): 7 digits of 4 bits per int32 limb, the first
#: digit in the top bits of limb 0, digit = label + 1, 0 = padding
LIMB_DIGITS = 7


def limb_keys(codes, l_max: int) -> np.ndarray:
    """The program's limb codes ``[N, L]`` as the reference's int64 keys.

    A row with a digit past ``2 * l_max`` cannot be a code of this
    ``l_max`` and reads -1, which no key equals."""
    if not 1 <= l_max <= MAX_L_MAX:
        raise ValueError(f"l_max={l_max} outside 1..{MAX_L_MAX}")
    codes = np.asarray(codes, dtype=np.int64)
    n, limbs = codes.shape
    shifts = 4 * (LIMB_DIGITS - 1 - np.arange(LIMB_DIGITS))
    digits = ((codes[:, :, None] >> shifts) & 0xF).reshape(
        n, limbs * LIMB_DIGITS)
    keep = 2 * l_max
    key = np.zeros(n, dtype=np.int64)
    for q in range(min(keep, digits.shape[1])):
        key |= digits[:, q] << (4 * (keep - 1 - q))
    bad = (digits[:, keep:] != 0).any(axis=1)
    return np.where(bad, -1, key)


def table_mismatch(prog_keys, prog_counts, ref_keys, ref_counts) -> int:
    """Codes whose counts differ between two tables, zero counts dropped,
    plus each duplicate among the program's keys."""
    pk = np.asarray(prog_keys, dtype=np.int64)
    pc = np.asarray(prog_counts, dtype=np.int64)
    rk = np.asarray(ref_keys, dtype=np.int64)
    rc = np.asarray(ref_counts, dtype=np.int64)
    pk, pc = pk[pc != 0], pc[pc != 0]
    rk, rc = rk[rc != 0], rc[rc != 0]
    uniq, first = np.unique(pk, return_index=True)
    dup = len(pk) - len(uniq)
    pk, pc = uniq, pc[first]
    both, pi, ri = np.intersect1d(pk, rk, assume_unique=True,
                                  return_indices=True)
    differ = int((pc[pi] != rc[ri]).sum())
    only = (len(pk) - len(both)) + (len(rk) - len(both))
    return int(dup + differ + only)


def dict_mismatch(prog: dict, ref: dict) -> int:
    """Codes whose counts differ between two ``{label string: count}``
    maps, zero counts dropped."""
    if prog == ref:
        return 0
    prog = {k: c for k, c in prog.items() if c != 0}
    ref = {k: c for k, c in ref.items() if c != 0}
    return sum(prog.get(k, 0) != ref.get(k, 0) for k in prog.keys() | ref)
