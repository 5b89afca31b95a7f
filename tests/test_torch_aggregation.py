"""Phase-2 signed aggregation of the port against the JAX package's
``CodeCounts``: every table byte for byte, masked rows included, and
``spilled`` exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as j_agg
from repro_torch.core import aggregation as t_agg
from repro_torch.core import convert
from repro_torch.core.executor import fold_fused


def _codes(seed, n, l_max, n_distinct=12, zero_every=5):
    """``n`` rows drawn from ``n_distinct`` valid limb codes of
    ``l_max``-edge processes (every digit 1..3), some rows all-zero."""
    rng = np.random.default_rng(seed)
    limbs = -(-2 * l_max // 7)
    pool = np.zeros((n_distinct, limbs), np.int32)
    for i in range(n_distinct):
        length = int(rng.integers(1, l_max + 1))
        for pos in range(2 * length):
            d = int(rng.integers(1, 4))
            pool[i, pos // 7] |= d << (4 * (6 - pos % 7))
    codes = pool[rng.integers(0, n_distinct, n)]
    codes[::zero_every] = 0
    weights = rng.integers(-2, 3, n).astype(np.int32)
    weights[::zero_every] = 0
    return codes, weights


def _assert_tables_equal(t, j):
    for a, b in zip(convert.counts_to_numpy(t), convert.counts_to_numpy(j)):
        assert a.dtype == b.dtype
        assert a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def _both(codes, weights):
    t = t_agg.count_codes(torch.as_tensor(codes), torch.as_tensor(weights))
    return t, j_agg.count_codes(jnp.asarray(codes), jnp.asarray(weights))


@pytest.mark.parametrize("l_max", [1, 3, 6, 7, 8, 14])
def test_count_codes_byte_equal(l_max):
    codes, weights = _codes(l_max, 300, l_max)
    _assert_tables_equal(*_both(codes, weights))


def _distinct(rng, n, limbs):
    """``n`` distinct non-zero codes of ``limbs`` 28-bit limbs, in
    limb-lexicographic order."""
    rows = rng.integers(1, 1 << 28, (2 * n + 8, limbs)).astype(np.int32)
    return np.unique(rows, axis=0)[:n]


def _nonzero_weights(rng, n, bound=5):
    w = rng.integers(1, bound + 1, n) * rng.choice([-1, 1], n)
    return w.astype(np.int32)


def _merge_shaped(rng, n_live=40, n=600, limbs=2):
    """What ``_compact`` sends to the merge: one sorted run of unique
    codes with their signed counts, then all-zero rows (here 93%)."""
    codes = np.zeros((n, limbs), np.int32)
    weights = np.zeros(n, np.int32)
    codes[:n_live] = _distinct(rng, n_live, limbs)
    weights[:n_live] = _nonzero_weights(rng, n_live)
    return codes, weights


def _shape_case(name, rng):
    if name == "merge":
        return _merge_shaped(rng)
    if name == "merge_4_ranks":
        codes, weights = _merge_shaped(rng)
        return np.concatenate([codes] * 4), np.concatenate([weights] * 4)
    if name == "single_group":
        codes = np.repeat(_distinct(rng, 1, 3), 257, axis=0)
        return codes, _nonzero_weights(rng, 257)
    if name == "all_distinct":
        codes = rng.permutation(_distinct(rng, 300, 2))
        return codes, _nonzero_weights(rng, 300)
    if name == "cancelling":
        pool = _distinct(rng, 30, 2)
        w = _nonzero_weights(rng, 30)
        codes = np.concatenate([pool, pool, _distinct(rng, 10, 2)])
        weights = np.concatenate([w, -w, _nonzero_weights(rng, 10)])
        order = rng.permutation(len(codes))
        return codes[order], weights[order]
    if name == "past_int32":
        pool = _distinct(rng, 4, 1)
        codes = pool[rng.integers(0, 4, 200)]
        weights = rng.integers(1 << 29, (1 << 31) - 1, 200).astype(np.int32)
        return codes, weights
    assert name == "all_padding"
    return np.zeros((500, 2), np.int32), np.zeros(500, np.int32)


@pytest.mark.parametrize("name", [
    "merge", "merge_4_ranks", "single_group", "all_distinct", "cancelling",
    "past_int32", "all_padding"])
def test_count_codes_byte_equal_on_shapes(name):
    """Inputs shaped as the step's callers send them, and the edge cases
    of a segment sum: padding-heavy merges, one group, no duplicates,
    counts cancelling to 0, and sums past 2**31 - 1 (which wrap as JAX's
    int32 ``segment_sum`` does)."""
    codes, weights = _shape_case(name, np.random.default_rng(26))
    if name == "past_int32":
        assert np.abs(weights.astype(np.int64)).sum() > 2**31 - 1
    t, j = _both(codes, weights)
    _assert_tables_equal(t, j)
    if name == "cancelling":
        assert (t.unique_mask & (t.counts == 0)).sum() == 30


def test_count_codes_is_deterministic():
    codes, weights = _shape_case("merge_4_ranks", np.random.default_rng(7))
    codes, weights = torch.as_tensor(codes), torch.as_tensor(weights)
    first = t_agg.count_codes(codes, weights)
    second = t_agg.count_codes(codes, weights)
    for a, b in zip(first, second):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_count_codes_orders_every_limb():
    """Codes that tie on their first limbs sort by the later ones (the
    second packed key of a 4-limb code)."""
    codes = np.zeros((6, 4), np.int32)
    codes[:, 0] = 1 << 24
    codes[:, 3] = [5 << 20, 1 << 20, 3 << 20, 1 << 20, 2 << 24, 7]
    weights = np.ones(6, np.int32)
    _assert_tables_equal(*_both(codes, weights))


def test_empty_and_all_padding_tables():
    _assert_tables_equal(*_both(np.zeros((0, 2), np.int32),
                                np.zeros(0, np.int32)))
    _assert_tables_equal(*_both(np.zeros((9, 2), np.int32),
                                np.zeros(9, np.int32)))
    _assert_tables_equal(t_agg.empty_counts(5, 3), j_agg.empty_counts(5, 3))


def test_aggregate_zones_byte_equal():
    rng = np.random.default_rng(3)
    codes, _ = _codes(3, 4 * 30, 5)
    codes = codes.reshape(4, 30, -1)
    lengths = rng.integers(0, 3, (4, 30)).astype(np.int32)
    signs = np.asarray([1, -1, 1, 0], np.int32)
    t = t_agg.aggregate_zones(*(torch.as_tensor(x)
                                for x in (codes, lengths, signs)))
    j = j_agg.aggregate_zones(*(jnp.asarray(x)
                                for x in (codes, lengths, signs)))
    _assert_tables_equal(t, j)


def test_merge_counts_byte_equal():
    ta, ja = _both(*_codes(10, 120, 6))
    tb, jb = _both(*_codes(11, 90, 6))
    _assert_tables_equal(t_agg.merge_counts(ta, tb),
                         j_agg.merge_counts(ja, jb))


@pytest.mark.parametrize("cap", [1, 2, 8, 13, 64, 400])
def test_merge_bounded_byte_equal_with_exact_spill(cap):
    ta, ja = _both(*_codes(20, 150, 7, n_distinct=40))
    tb, jb = _both(*_codes(21, 150, 7, n_distinct=40))
    t_out, t_sp = t_agg.merge_bounded(ta, tb, cap=cap)
    j_out, j_sp = j_agg.merge_bounded(ja, jb, cap=cap)
    _assert_tables_equal(t_out, j_out)
    assert t_sp.dtype == torch.int32
    assert int(t_sp) == int(j_sp)
    if cap <= 8:
        assert int(t_sp) > 0


def test_live_rows_zero_cancelled_rows():
    codes = np.asarray([[1 << 24], [2 << 24], [1 << 24]], np.int32)
    weights = np.asarray([1, 1, -1], np.int32)
    t, j = _both(codes, weights)
    for a, b in zip(t_agg.live_rows(t), j_agg.live_rows(j)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("merge_cap", [16, 4096])
def test_fold_fused_matches_chunked_jax_fold(merge_cap):
    """The fused path's fold (count_codes + merge_bounded over fold-chunk
    slices) equals the same chain of JAX calls, spill count included."""
    rng = np.random.default_rng(5)
    s, fold_chunk = 1024, 256
    code, _ = _codes(5, s, 6, n_distinct=60, zero_every=7)
    length = rng.integers(0, 4, s).astype(np.int32)
    sign = rng.choice(np.asarray([1, -1, 0], np.int32), s)
    t_counts, t_sp = fold_fused(
        *(torch.as_tensor(x) for x in (code, length, sign)),
        fold_chunk=fold_chunk, merge_cap=merge_cap)
    w = (length > 0).astype(np.int32) * sign
    codes = np.where(w[:, None] != 0, code, 0)
    carry = j_agg.empty_counts(merge_cap, code.shape[1])
    spilled = 0
    for i in range(s // fold_chunk):
        sl = slice(i * fold_chunk, (i + 1) * fold_chunk)
        part = j_agg.count_codes(jnp.asarray(codes[sl]), jnp.asarray(w[sl]))
        carry, sp = j_agg.merge_bounded(carry, part, cap=merge_cap)
        spilled += int(sp)
    _assert_tables_equal(t_counts, carry)
    assert int(t_sp) == spilled
    assert (spilled > 0) == (merge_cap == 16)
