"""Capacity planner — derive fused-path capacities from a memory budget.

The fused single-launch path keeps the whole concatenated slot stream on
the device: the kernel's inputs and outputs, then a fold of the candidate
codes through a bounded count table in ``fold_chunk``-row slices.  Its
one free memory knob is ``fold_chunk``; this module owns the arithmetic:

* :func:`count_table_bytes` — the device footprint of one sort-based
  signed count (:func:`repro_torch.core.aggregation.count_codes`) over a
  number of rows;
* :func:`fused_peak_bytes` — the fused path's peak device memory;
* :func:`default_fold_chunk` / :func:`plan_fused_capacity` — the fold
  chunk, by default or as the largest that fits a budget;
* :func:`fused_sweep_slots` / :func:`padded_sweep_slots` — the dispatched
  sweep-work models of the fused and per-bucket layouts.

Every term counts the tensors the port allocates in device memory (HBM on
an H100); a kernel's lane state lives in registers and costs nothing here.
Estimates are analytic, not measured — they exist to pick sane shapes.
"""

from __future__ import annotations

import dataclasses

from . import encoding

#: int32 flat inputs of a fused launch: u, v, t, valid, zone_id, sign
_FUSED_INPUTS = 6


def _count_row_bytes(limbs: int) -> int:
    """Device bytes per row of one :func:`aggregation.count_codes` call.

    Limbs pack pairwise into int64 sort keys; each chained stable sort
    holds its key (gathered through the running permutation), the sorted
    values and the int64 indices, and composes an int64 permutation.  Then
    the permuted codes and weights, the boundary mask and int64 group ids,
    and the output table (codes, int32 counts, bool mask).
    """
    n_keys = -(-limbs // 2)
    sort = n_keys * (8 + 8 + 8 + 8) + 8
    permuted = 4 * limbs + 4
    groups = 1 + 8
    table = 4 * limbs + 4 + 1
    return sort + permuted + groups + table


def count_table_bytes(rows: int, l_max: int) -> int:
    """Footprint of one signed count over ``rows`` (code, weight) rows."""
    return rows * _count_row_bytes(encoding.n_limbs(l_max))


def fused_peak_bytes(n_slots: int, l_max: int, *, fold_chunk: int,
                     merge_cap: int, blk: int = 512) -> int:
    """Peak estimate of the fused single-launch path.

    The concatenated stream's resident state: six flat int32 inputs and
    the per-block ``lo``/``hi`` windows, the kernel's ``[S, L]`` code and
    ``[S]`` length outputs, the fold's weighted copy of both (codes masked
    by their weight), the bounded merge carry, and one fold step's count
    over ``fold_chunk + merge_cap`` rows.
    """
    limbs = encoding.n_limbs(l_max)
    inputs = _FUSED_INPUTS * 4 * n_slots + 2 * 4 * (n_slots // blk)
    outputs = n_slots * (4 * limbs + 4)
    weighted = n_slots * (4 * limbs + 4)
    carry = merge_cap * (4 * limbs + 4 + 1)
    return (inputs + outputs + weighted + carry
            + count_table_bytes(fold_chunk + merge_cap, l_max))


def default_fold_chunk(n_slots: int, *, blk: int) -> int:
    """Fold-chunk default: ~4096 candidate rows per on-device fold step,
    scaled up (to at most 16384) once the stream is large enough that the
    sequential merge chain would dominate — every fold step pays an
    O(merge_cap) bounded merge regardless of chunk size, so a big stream
    folded in 4096-row steps spends more time merging than scanning.
    Rounded to a ``blk`` multiple and clamped to the (blk-aligned) stream
    so tiny layouts do not pad up to a chunk they cannot fill."""
    scaled = min(16384, n_slots // 8) // blk * blk
    target = max(blk, 4096 // blk * blk, scaled)
    slots = max(-(-max(n_slots, 1) // blk) * blk, blk)
    return min(target, slots)


@dataclasses.dataclass(frozen=True)
class FusedCapacityPlan:
    """Budget-derived capacities for the fused single-launch path."""

    fold_chunk: int
    merge_cap: int
    budget_bytes: int
    est_peak_bytes: int

    @property
    def fits(self) -> bool:
        return self.est_peak_bytes <= self.budget_bytes


def plan_fused_capacity(
    *,
    n_slots: int,
    l_max: int,
    memory_budget_mb: float,
    blk: int,
    merge_cap: int | None = None,
) -> FusedCapacityPlan:
    """Largest ``blk``-multiple ``fold_chunk`` whose fused peak fits.

    The fold chunk is the only free memory knob (the stream itself is
    workload-determined), doubling from ``blk`` while the estimate stays
    under budget.  ``merge_cap`` defaults to one fold chunk's rows (at
    least 1024).
    """
    if memory_budget_mb <= 0:
        raise ValueError("memory_budget_mb must be > 0")
    budget = int(memory_budget_mb * 2**20)
    ceiling = default_fold_chunk(n_slots, blk=blk)

    def peak(fc: int) -> int:
        cap = merge_cap if merge_cap is not None else max(1024, fc)
        return fused_peak_bytes(n_slots, l_max, fold_chunk=fc,
                                merge_cap=cap, blk=blk)

    fc = blk
    while fc * 2 <= ceiling and peak(fc * 2) <= budget:
        fc *= 2
    cap = merge_cap if merge_cap is not None else max(1024, fc)
    return FusedCapacityPlan(
        fold_chunk=fc, merge_cap=cap, budget_bytes=budget,
        est_peak_bytes=peak(fc),
    )


def padded_sweep_slots(bucket_shapes) -> int:
    """Padded pairwise sweep work ``sum(Z_b * e_cap_b**2)`` of a layout —
    the dense per-bucket cost model."""
    return sum(int(z) * int(e) ** 2 for z, e in bucket_shapes)


def fused_sweep_slots(lo, hi, blk: int) -> int:
    """Dispatched sweep work of a fused flat stream in the block model:
    each candidate block of ``blk`` lanes spans its ``[lo, hi)`` window,
    so the slot-cell cost is ``blk * sum(hi - lo)``.  Tightening ``hi`` to
    the Lemma-4.1 horizon cut (``tzp.concat_layout(bounds="live")``)
    shrinks it directly.  The CUDA kernel's threads stop earlier still
    (at their row end or on early exit): the steps it really takes are
    :func:`repro_torch.kernels.zone_scan.ref.live_steps`."""
    return int(blk) * int(sum(int(h) - int(l) for l, h in zip(lo, hi)))
