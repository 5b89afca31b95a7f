"""How the port's signed count is computed, without JAX: the aten ops
``count_codes`` dispatches (one writer per output row, so no atomic
``index_add`` and no duplicate-writing ``index_put``), and on the card
the merge's padding-heavy table at the mining step's size, byte for byte
the CPU result and a plain numpy count.  The JAX package's tables are
held in ``test_torch_aggregation.py``."""

import collections

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import aggregation


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


def _merge_table(n, live_share, limbs, seed):
    """What the step's merge counts: a sorted run of distinct codes with
    signed counts, then all-zero padding rows."""
    rng = np.random.default_rng(seed)
    n_live = round(n * live_share)
    rows = rng.integers(1, 1 << 28, (n_live + n_live // 8 + 8, limbs))
    codes = np.zeros((n, limbs), np.int32)
    codes[:n_live] = np.unique(rows.astype(np.int32), axis=0)[:n_live]
    weights = np.zeros(n, np.int32)
    weights[:n_live] = rng.integers(1, 6, n_live) * rng.choice([-1, 1],
                                                              n_live)
    return codes, weights


def _plain_count(codes, weights):
    """The same table by ``np.unique`` and an exact float64 sum, wrapped
    to int32."""
    n, limbs = codes.shape
    uniq, inverse = np.unique(codes, axis=0, return_inverse=True)
    sums = np.bincount(inverse.reshape(-1), weights=weights.astype(np.float64),
                       minlength=len(uniq))
    out_codes = np.zeros((n, limbs), np.int32)
    out_codes[:len(uniq)] = uniq
    counts = np.zeros(n, np.int32)
    counts[:len(uniq)] = sums.astype(np.int64).astype(np.int32)
    mask = np.zeros(n, bool)
    mask[:len(uniq)] = (uniq != 0).any(axis=1)
    return out_codes, counts, mask


def _assert_equal_to(table, want):
    for got, w in zip(table, want):
        got = got.cpu().numpy()
        assert got.dtype == w.dtype and got.shape == w.shape
        assert got.tobytes() == w.tobytes()


@pytest.mark.parametrize("limbs", [1, 2, 4])
def test_count_codes_dispatches_no_scatter(limbs):
    """Every output row is gathered from its group's last sorted row: the
    padding group's rows do not add into one address."""
    codes, weights = _merge_table(4096, 0.0565, limbs, seed=limbs)
    with _Ops() as mode:
        table = aggregation.count_codes(torch.as_tensor(codes),
                                        torch.as_tensor(weights))
    assert not [op for op in mode.ops
                if "index_add" in op or "index_put" in op]
    _assert_equal_to(table, _plain_count(codes, weights))


def test_count_codes_on_card_at_merge_size():
    """The mining step's merge: 4,194,304 rows, 5.65% of them live codes
    of 2 limbs (l_max 6), the rest padding; the card's table equals the
    CPU's and a plain count, and repeats exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CPU cases run above")
    codes, weights = _merge_table(4_194_304, 0.0565, 2, seed=26)
    args = torch.as_tensor(codes), torch.as_tensor(weights)
    cpu = aggregation.count_codes(*args)
    _assert_equal_to(cpu, _plain_count(codes, weights))
    card = [aggregation.count_codes(*(a.cuda() for a in args))
            for _ in range(2)]
    want = [x.numpy() for x in cpu]
    for table in card:
        _assert_equal_to(table, want)
