"""Deterministic relabeling encoding (PTMT Phase 3).

The paper encodes a motif transition process as the concatenation of
first-occurrence node labels of its edges, e.g. ``(A,B),(B,C),(A,C)`` becomes
the string ``"010212"``.  Strings and hash maps do not vectorize on a GPU, so
codes are stored as fixed-width **multi-limb int32 words**:

* each digit is ``label + 1`` in 4 bits (0 is reserved for padding, which makes
  codes self-delimiting: the number of non-zero digits is exactly ``2 * l``);
* 7 big-endian digits per limb (28 bits, the int32 sign bit stays clear);
* ``n_limbs = ceil(2 * l_max / 7)`` limbs per code.

Because digits are big-endian and padding is 0, integer-lexicographic order on
the limb tuple groups every process under its transition prefix — the property
Phase 3's string encoding provides, preserved for sort-based counting.

A connected ``l``-edge motif has at most ``l + 1`` nodes, so labels fit in
``[0, l_max]`` and 4-bit digits support ``l_max <= 14`` (the paper sweeps to 12).

The torch functions (:func:`append_digit`, :func:`empty_code`,
:func:`truncate_codes`) work on tensors of any device; the ``*_np`` helpers
are host-side numpy for reporting and tests.
"""

from __future__ import annotations

import numpy as np
import torch

DIGIT_BITS = 4
DIGITS_PER_LIMB = 7
_LIMB_MASK = (1 << (DIGIT_BITS * DIGITS_PER_LIMB)) - 1


def n_limbs(l_max: int) -> int:
    """Number of int32 limbs needed for ``2 * l_max`` digits."""
    if l_max > 14:
        raise ValueError(f"l_max={l_max} > 14 exceeds 4-bit label digits")
    return -(-2 * l_max // DIGITS_PER_LIMB)


def digit_shift(pos):
    """Bit shift of digit position ``pos`` *within its limb* (big-endian)."""
    return DIGIT_BITS * (DIGITS_PER_LIMB - 1 - pos % DIGITS_PER_LIMB)


def append_digit(code, pos, digit):
    """Add ``digit`` at global digit position ``pos`` into ``code[..., L]``.

    Vectorized over leading axes; ``pos``/``digit`` (int32 tensors)
    broadcast against ``code[..., 0]``.  The target slot must currently be
    zero.
    """
    limbs = code.shape[-1]
    limb_idx = torch.div(pos, DIGITS_PER_LIMB, rounding_mode="floor")
    add = torch.bitwise_left_shift(digit.to(torch.int32), digit_shift(pos))
    onehot = (
        torch.arange(limbs, dtype=torch.int32, device=code.device)
        == limb_idx[..., None]
    ).to(torch.int32)
    return code + onehot * add[..., None]


def empty_code(shape, l_max: int, *, device=None):
    return torch.zeros((*shape, n_limbs(l_max)), dtype=torch.int32,
                       device=device)


def truncate_codes(code, lengths):
    """Truncate limb codes to their first ``lengths`` edges (vectorized).

    The torch analog of :func:`prefix_code_np` with a per-row level: keeps
    the first ``2 * lengths[...]`` digits of ``code[..., L]`` and zeroes
    the rest.  Because label assignment is first-occurrence over the edge
    sequence, a truncated code equals the code of the prefix process — the
    property the config-lattice co-mining fold relies on to split one
    dominating sweep into per-config count tables.
    """
    limbs = code.shape[-1]
    keep = 2 * lengths.to(torch.int32)
    limb_iota = torch.arange(limbs, dtype=torch.int32, device=code.device)
    n_keep = torch.clamp(keep[..., None] - limb_iota * DIGITS_PER_LIMB,
                         0, DIGITS_PER_LIMB)
    full = torch.full_like(n_keep, _LIMB_MASK)
    mask = torch.bitwise_xor(
        torch.bitwise_right_shift(full, DIGIT_BITS * n_keep), _LIMB_MASK)
    return code & mask


# ---------------------------------------------------------------------------
# Host-side (numpy) helpers for reporting / tests.
# ---------------------------------------------------------------------------


def encode_digits_np(digits, l_max: int) -> np.ndarray:
    """Pack a python list of digit values (label+1, 1-based) into limbs."""
    limbs = np.zeros(n_limbs(l_max), dtype=np.int32)
    for pos, d in enumerate(digits):
        if not 1 <= d <= 15:
            raise ValueError(f"digit {d} out of 4-bit 1-based range")
        limbs[pos // DIGITS_PER_LIMB] |= d << digit_shift(pos)
    return limbs


def encode_label_string_np(s: str, l_max: int) -> np.ndarray:
    """Encode a paper-style label string (e.g. ``"0101"``) into limbs."""
    return encode_digits_np([int(c, 16) + 1 for c in s], l_max)


def decode_code_np(limbs) -> str:
    """Limb code → paper-style label string (e.g. ``"010212"``)."""
    out = []
    for limb in np.asarray(limbs).tolist():
        for pos in range(DIGITS_PER_LIMB):
            d = (limb >> (DIGIT_BITS * (DIGITS_PER_LIMB - 1 - pos))) & 0xF
            if d == 0:
                continue
            out.append(format(d - 1, "x"))
    return "".join(out)


def code_length_np(limbs) -> int:
    """Number of edges encoded in a limb code."""
    return len(decode_code_np(limbs)) // 2


def encode_process_np(edges, l_max: int) -> np.ndarray:
    """Encode an explicit edge sequence ``[(u, v), ...]`` (host-side oracle)."""
    labels: dict[int, int] = {}
    digits = []
    for u, v in edges:
        for node in (u, v):
            if node not in labels:
                labels[node] = len(labels)
        digits.append(labels[u] + 1)
        digits.append(labels[v] + 1)
    return encode_digits_np(digits, l_max)


def prefix_range_np(s: str, l_max: int) -> tuple[np.ndarray, np.ndarray]:
    """Inclusive limb-code bounds of every code extending prefix ``s``.

    Because digits are big-endian within fixed-width limbs and padding is 0,
    the codes whose label string starts with ``s`` are exactly the codes
    ``c`` with ``lo <= c <= hi`` in integer-lexicographic limb order, where
    ``lo`` is ``s`` followed by zero digits and ``hi`` is ``s`` followed by
    all-0xF digits.  This is what lets the serving layer answer
    ``prefix_count`` with two binary searches over a sorted code index
    instead of a full scan.
    """
    lo = encode_label_string_np(s, l_max)
    hi = lo.copy()
    for pos in range(len(s), n_limbs(l_max) * DIGITS_PER_LIMB):
        hi[pos // DIGITS_PER_LIMB] |= 0xF << digit_shift(pos)
    return lo, hi


def code_key_np(limbs) -> bytes:
    """Limb code → big-endian byte key; bytewise order == integer-lex order.

    Each int32 limb is non-negative (28 data bits), so serializing limbs as
    big-endian uint32 and concatenating preserves the integer-lexicographic
    order on limb tuples under plain ``bytes`` comparison.
    """
    return np.ascontiguousarray(np.asarray(limbs), dtype=">u4").tobytes()


def prefix_code_np(limbs, level: int) -> np.ndarray:
    """Truncate a limb code to its first ``level`` edges (2*level digits)."""
    limbs = np.asarray(limbs).copy()
    keep_digits = 2 * level
    for m in range(limbs.shape[-1]):
        lo = m * DIGITS_PER_LIMB
        n_keep = int(np.clip(keep_digits - lo, 0, DIGITS_PER_LIMB))
        mask = (_LIMB_MASK >> (DIGIT_BITS * n_keep)) ^ _LIMB_MASK if n_keep else 0
        limbs[..., m] &= mask
    return limbs
