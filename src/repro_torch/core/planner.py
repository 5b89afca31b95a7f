"""Capacity planner — derive mining capacities from a memory budget.

Two paths, two sets of terms:

* the **fused** single-launch path keeps the whole concatenated slot
  stream on the device: the kernel's inputs and outputs, then a fold of
  the candidate codes through a bounded count table in
  ``fold_chunk``-row slices.  Its one free memory knob is ``fold_chunk``:
  :func:`count_table_bytes` (one sort-based signed count,
  :func:`repro_torch.core.aggregation.count_codes`), :func:`fused_peak_bytes`,
  :func:`default_fold_chunk` and :func:`plan_fused_capacity`.  These terms
  count the tensors the port allocates in device memory (HBM on an H100);
  a kernel's lane state lives in registers and costs nothing here;
* the **per-bucket** path scans ``[Z, E]`` zone batches in chunks of
  ``zone_chunk`` zones and folds them through a ``merge_cap``-row carry:
  a per-zone **memory model** of the scan (:func:`ref_zone_bytes` for the
  torch reference, :func:`cuda_zone_bytes` for the dense CUDA kernel),
  :func:`legacy_peak_bytes`, :func:`hierarchical_peak_bytes`, and
  :func:`plan_capacity` / :func:`plan_layout_capacity`, which pick the
  largest power-of-two ``zone_chunk`` whose peak fits.  These keep the
  JAX package's arithmetic term for term (its sort model of a count table
  included), so a budget derives the same chunks, merge caps — and hence
  the same launches and spill retries — as the reference for the same
  memory model.  :func:`suggest_e_cap` answers the inverse question: the
  largest zone capacity a budget holds.

:func:`fused_sweep_slots` / :func:`padded_sweep_slots` are the dispatched
sweep-work models of the two layouts, :func:`fused_traffic_bytes` the
fused launch's traffic model (:func:`fused_input_bytes` its reads), and
the **config lattice** (:class:`ConfigLattice`,
:func:`build_config_lattices`) groups co-minable configs into shared
dominating sweeps.

Estimates are analytic, not measured — they exist to pick sane shapes.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from . import encoding

#: int32 flat inputs of a fused launch: u, v, t, valid, zone_id, sign
_FUSED_INPUTS = 6


def _count_row_bytes(limbs: int) -> int:
    """Device bytes per row of one :func:`aggregation.count_codes` call.

    Limbs pack pairwise into int64 sort keys; each chained stable sort
    holds its key (gathered through the running permutation), the sorted
    values and the int64 indices, and composes an int64 permutation.  Then
    the permuted codes and weights, the boundary mask and int64 group ids;
    the int64 row indices, group ends (a search of the ids), the weights'
    int64 prefix sum and its copy gathered at the ends; and the output
    table, gathered at the group ends (codes gathered then masked, int32
    counts, bool mask).
    """
    n_keys = -(-limbs // 2)
    sort = n_keys * (8 + 8 + 8 + 8) + 8
    permuted = 4 * limbs + 4
    groups = 1 + 8
    segments = 8 + 8 + 8 + 8
    table = 2 * 4 * limbs + 4 + 1
    return sort + permuted + groups + segments + table


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


def fused_input_bytes(fl) -> int:
    """Bytes one fused launch must read at the least (int32 everywhere):
    each slot's ``u, v, t, valid, zone_id`` once, 5 x 4 B x ``n_slots``,
    and each block's ``hi``, 4 B x ``n_blocks`` (the flat kernel reads no
    ``lo``).  ``fl`` is a :class:`repro_torch.core.tzp.FusedZoneLayout`."""
    return fl.n_slots * 5 * 4 + fl.n_blocks * 4


def fused_traffic_bytes(fl, l_max: int) -> int:
    """Traffic model of one fused launch: the bytes it must move at the
    least (int32 everywhere).

    * inputs and descriptors — :func:`fused_input_bytes`;
    * outputs — per-lane code limbs + length: ``(limbs + 1) x 4 B x
      n_slots`` written by the kernel, read back by the on-device fold.

    ``fl`` is a :class:`repro_torch.core.tzp.FusedZoneLayout`.  It is a
    model, not a measurement: a rate made from it is modelled bytes over a
    measured time.  It is not the JAX package's model, which counts the
    Pallas launch's chunk loads (each block streaming its ``[lo, hi)``
    window once).  The CUDA kernel stages no such chunks, so this model
    counts each slot once, the least any implementation must read.
    """
    limbs = encoding.n_limbs(l_max)
    return fused_input_bytes(fl) + fl.n_slots * (limbs + 1) * 4 * 2


# ---------------------------------------------------------------------------
# Per-bucket capacities: zone chunks and merge caps of [Z, E] batches.
# ---------------------------------------------------------------------------

# host->device inputs: u, v, t int32 + valid bool, per edge slot
_INPUT_BYTES_PER_EDGE = 13
# the per-bucket count model: ~2 copies of the (code, count) row stream
# (operand + sorted output) before the segment-sum
_SORT_COPIES = 2


def ref_zone_bytes(e_cap: int, l_max: int) -> int:
    """Per-zone scan footprint of the torch reference expansion.

    inputs (u, v, t, valid) + ZoneState (length, last_t, n_nodes int32;
    done bool; nodes int32[E, l_max+1]; code int32[E, L]) + ZoneResult
    (code int32[E, L], length int32[E]).
    """
    limbs = encoding.n_limbs(l_max)
    k = l_max + 1
    state = 13 + 4 * k + 4 * limbs
    out = 4 * limbs + 4
    return e_cap * (_INPUT_BYTES_PER_EDGE + state + out)


def cuda_zone_bytes(e_cap: int, l_max: int) -> int:
    """Per-zone footprint of the dense CUDA kernel (``zone_scan.cu``).

    What the wrapper allocates per slot: the 4 int32 inputs (u, v, t and
    valid widened to int32) and the ``L + 1`` int32 outputs (code limbs,
    length).  Lane state lives in registers, and the kernel pads nothing:
    unlike the JAX package's ``pallas_zone_bytes``, no VMEM tile of
    ``c_blk x e_blk`` is modelled.  The co-mining ``ts`` output is counted
    by :func:`comine_peak_bytes`.
    """
    return e_cap * 4 * (4 + encoding.n_limbs(l_max) + 1)


def _sorted_table_bytes(rows: int, l_max: int) -> int:
    """Per-bucket model of one sorted count table of ``rows`` rows."""
    limbs = encoding.n_limbs(l_max)
    return _SORT_COPIES * rows * 4 * (limbs + 1)


def legacy_peak_bytes(n_zones: int, e_cap: int, l_max: int, *,
                      zone_chunk: int = 0,
                      mem_model: Callable[[int, int], int] | None = None,
                      ) -> int:
    """Peak estimate of whole-batch aggregation: O(Z*C) regardless of
    chunking — every zone's candidate codes exist before the one count."""
    model = mem_model or ref_zone_bytes
    limbs = encoding.n_limbs(l_max)
    chunk = min(zone_chunk, n_zones) if zone_chunk else n_zones
    scan_state = chunk * model(e_cap, l_max)
    all_codes = n_zones * e_cap * (4 * limbs + 4)
    return scan_state + all_codes + _sorted_table_bytes(n_zones * e_cap,
                                                        l_max)


def hierarchical_peak_bytes(zone_chunk: int, e_cap: int, l_max: int, *,
                            merge_cap: int,
                            mem_model: Callable[[int, int], int] | None = None,
                            ) -> int:
    """Peak estimate of the chunked fold: independent of the zone count."""
    model = mem_model or ref_zone_bytes
    scan_state = zone_chunk * model(e_cap, l_max)
    merge_rows = merge_cap + zone_chunk * e_cap
    limbs = encoding.n_limbs(l_max)
    carry = merge_cap * 4 * (limbs + 1)
    return scan_state + carry + _sorted_table_bytes(merge_rows, l_max)


def default_merge_cap(zone_chunk: int, e_cap: int) -> int:
    """One chunk's candidate rows (at least 1024): the first chunk can
    never spill, and the carry is no bigger than the partial table it
    merges with."""
    return max(1024, zone_chunk * e_cap)


@dataclasses.dataclass(frozen=True)
class CapacityPlan:
    """Budget-derived per-bucket capacities (all sizes in bytes)."""

    zone_chunk: int
    merge_cap: int
    budget_bytes: int
    per_zone_bytes: int
    est_peak_bytes: int

    @property
    def fits(self) -> bool:
        return self.est_peak_bytes <= self.budget_bytes


def plan_capacity(
    *,
    n_zones: int,
    e_cap: int,
    l_max: int,
    memory_budget_mb: float,
    mem_model: Callable[[int, int], int] | None = None,
    merge_cap: int | None = None,
) -> CapacityPlan:
    """Largest power-of-two ``zone_chunk`` whose hierarchical peak fits.

    ``merge_cap`` defaults to one chunk's candidate rows and scales with
    the chosen chunk.  The floor is ``zone_chunk=1``; a plan whose
    ``fits`` is False means even one zone exceeds the budget.
    """
    if memory_budget_mb <= 0:
        raise ValueError("memory_budget_mb must be > 0")
    n_zones = max(int(n_zones), 1)
    budget = int(memory_budget_mb * 2**20)

    def peak(zc: int) -> int:
        cap = merge_cap if merge_cap is not None else default_merge_cap(
            zc, e_cap)
        return hierarchical_peak_bytes(zc, e_cap, l_max, merge_cap=cap,
                                       mem_model=mem_model)

    zc = 1
    while zc * 2 <= n_zones and peak(zc * 2) <= budget:
        zc *= 2
    cap = merge_cap if merge_cap is not None else default_merge_cap(zc, e_cap)
    model = mem_model or ref_zone_bytes
    return CapacityPlan(
        zone_chunk=zc,
        merge_cap=cap,
        budget_bytes=budget,
        per_zone_bytes=model(e_cap, l_max),
        est_peak_bytes=peak(zc),
    )


def plan_layout_capacity(
    bucket_shapes,
    *,
    l_max: int,
    memory_budget_mb: float,
    mem_model: Callable[[int, int], int] | None = None,
    merge_cap: int | None = None,
) -> dict[tuple[int, int], CapacityPlan]:
    """Per-bucket capacity plans for a size-bucketed zone layout.

    ``bucket_shapes`` is a sequence of ``(n_zones, e_cap)`` pairs; each
    bucket's plan derives from its own edge capacity (duplicates collapse
    to one plan).  The executor derives the same plans at run time
    (:meth:`~repro_torch.core.executor.MiningExecutor.capacity_plan`).
    """
    return {
        shape: plan_capacity(
            n_zones=shape[0], e_cap=shape[1], l_max=l_max,
            memory_budget_mb=memory_budget_mb, mem_model=mem_model,
            merge_cap=merge_cap,
        )
        for shape in dict.fromkeys(tuple(s) for s in bucket_shapes)
    }


def layout_peak_bytes(plans: dict[tuple[int, int], CapacityPlan]) -> int:
    """Peak estimate of a bucketed run: buckets run one after another, so
    the layout's peak is the worst single bucket, not the sum."""
    return max((p.est_peak_bytes for p in plans.values()), default=0)


# ---------------------------------------------------------------------------
# Config lattice — grouping N tenant configs into shared dominating sweeps.
# ---------------------------------------------------------------------------

# Fields a lattice member may vary while still sharing one Phase-1 sweep.
# ``delta``/``l_max`` shrink losslessly from the dominating sweep by prefix-
# truncating candidates on absorption timestamps; ``omega`` only shapes zone
# geometry (never counts), so planning at the max omega is exact.
_LATTICE_FREE_FIELDS = ("delta", "l_max", "omega")


@dataclasses.dataclass(frozen=True)
class ConfigLattice:
    """One co-minable group of configs plus its dominating sweep config.

    ``members`` keep the caller's order; ``indices`` are their positions
    in the original request.  ``dominating`` is the member-wise maximum
    over the free fields — every member's process table is a
    prefix-truncation of the dominating sweep's (see
    :func:`repro_torch.core.expansion.derive_lengths`).
    """

    dominating: object                  # MiningConfig (duck-typed)
    members: tuple                      # tuple[MiningConfig, ...]
    indices: tuple[int, ...]

    @property
    def n_configs(self) -> int:
        return len(self.members)

    @property
    def params(self) -> tuple[tuple[int, int], ...]:
        """Per-member ``(delta, l_max)`` — the executor fold's key."""
        return tuple((m.delta, m.l_max) for m in self.members)


def lattice_key(config) -> tuple:
    """Compatibility key: everything about a config *except* the free
    fields.  Configs with equal keys can share one dominating sweep."""
    d = config.to_dict()
    for f in _LATTICE_FREE_FIELDS:
        d.pop(f, None)
    return tuple(sorted(d.items()))


def dominating_config(configs):
    """The member-wise max config a lattice plans its shared sweep at."""
    if not configs:
        raise ValueError("dominating_config needs at least one config")
    return configs[0].with_updates(
        delta=max(c.delta for c in configs),
        l_max=max(c.l_max for c in configs),
        omega=max(c.omega for c in configs),
    )


def build_config_lattices(configs) -> list[ConfigLattice]:
    """Group configs into co-minable lattices (input order preserved).

    Configs differing only in ``delta``/``l_max``/``omega`` land in one
    lattice; anything else (backend, e_cap, zone layout, merge caps, ...)
    splits them, because those change the sweep itself rather than how
    its candidate table is folded.
    """
    groups: dict[tuple, list[int]] = {}
    for i, cfg in enumerate(configs):
        groups.setdefault(lattice_key(cfg), []).append(i)
    return [
        ConfigLattice(
            dominating=dominating_config([configs[i] for i in idxs]),
            members=tuple(configs[i] for i in idxs),
            indices=tuple(idxs),
        )
        for idxs in groups.values()
    ]


def comine_peak_bytes(zone_chunk: int, e_cap: int, l_max_dom: int, *,
                      merge_caps, mem_model=None) -> int:
    """Peak estimate of the multi-config per-bucket fold.

    One dominating-config scan chunk (plus its ``ts`` int32[E, l_max]
    table) is resident at a time, and every member keeps its own bounded
    carry; the fold counts one member at a time, so the count-table term
    scales with the largest member cap while the carry term sums over
    members.
    """
    model = mem_model or ref_zone_bytes
    scan_state = zone_chunk * (model(e_cap, l_max_dom) + 4 * l_max_dom * e_cap)
    limbs = encoding.n_limbs(l_max_dom)
    carry = sum(cap * 4 * (limbs + 1) for cap in merge_caps)
    worst = max(merge_caps, default=0)
    return scan_state + carry + _sorted_table_bytes(
        worst + zone_chunk * e_cap, l_max_dom)


def suggest_e_cap(
    *,
    l_max: int,
    memory_budget_mb: float,
    zone_chunk: int = 1,
    mem_model: Callable[[int, int], int] | None = None,
    pad_edges_to: int = 8,
) -> int:
    """Largest power-of-two zone edge capacity whose per-bucket
    hierarchical peak fits the budget with ``zone_chunk`` zones in flight
    (how dense a zone the device can hold at all)."""
    if memory_budget_mb <= 0:
        raise ValueError("memory_budget_mb must be > 0")
    budget = int(memory_budget_mb * 2**20)
    e = pad_edges_to
    while hierarchical_peak_bytes(
            zone_chunk, e * 2, l_max,
            merge_cap=default_merge_cap(zone_chunk, e * 2),
            mem_model=mem_model) <= budget:
        e *= 2
        if e >= 1 << 24:        # 16M edges per zone: beyond any real batch
            break
    return e
