"""Mining executor — the scan + aggregate engine behind every entry point.

:class:`MiningExecutor` runs Phase 1 (candidate expansion) and Phase 2
(signed aggregation) on one device:

* backend dispatch goes through :mod:`repro_torch.core.backends`;
* the **fused path** (:meth:`MiningExecutor.run_fused`) mines a whole zone
  layout with ONE kernel launch over a concatenated flat slot stream, then
  folds the candidate codes on the device through
  :func:`repro_torch.core.aggregation.count_codes` +
  :func:`~repro_torch.core.aggregation.merge_bounded` in ``fold_chunk``-row
  slices (:func:`fold_fused`); only the bounded count table and the spill
  counter leave the device.  A spill (more live unique codes than
  ``merge_cap``) is exact, so the fold retries with a doubled cap —
  the kernel's output is kept, so a retry re-runs the fold, not the
  launch;
* the **per-bucket path** (:meth:`MiningExecutor.run_layout` with no fused
  scan, and :meth:`MiningExecutor.run` for one padded ``[Z, E]`` batch —
  the sequential baseline's one-zone batch takes it) scans each bucket
  with the backend's per-zone scan, in chunks of ``zone_chunk`` zones
  (explicit, or derived from ``memory_budget_mb`` by
  :mod:`repro_torch.core.planner`), with an explicit **pad**/**raise**
  policy for zone counts that do not divide it.  Phase 2 has three modes
  (``agg``):

  - ``"legacy"``      — every chunk's candidate codes, then one
                        whole-batch signed count (peak O(Z*C));
  - ``"hierarchical"``— each chunk's codes are counted at once and merged
                        into a bounded ``merge_cap``-row carry
                        (:func:`~repro_torch.core.aggregation.
                        merge_bounded`): peak O(zone_chunk*C + merge_cap).
                        Spills are detected exactly and the bucket re-runs
                        with a doubled cap, so results are always exact;
  - ``"pipelined"``   — the same fold, with the next chunk's
                        host-to-device copy issued on a side CUDA stream
                        (from pinned memory) while the current chunk
                        computes;
  - ``"auto"`` (default) resolves to ``"hierarchical"`` when chunking is
    active and ``"legacy"`` otherwise (identical counts either way).

  Per-bucket tables then merge through the same bounded carry
  (:func:`merge_partial_counts`).  A host-only backend (``numpy``) scans
  each chunk on the host; its results are folded on the device;
* **config-lattice co-mining** (:meth:`MiningExecutor.run_layout_multi`)
  derives N member configs' tables from ONE dominating ``with_ts`` sweep,
  on either path.

The executor runs on ``device``: CUDA unless the caller passes
``device="cpu"``; with no CUDA device and no explicit device it raises.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.obs import get_obs

from . import aggregation, backends, encoding, expansion, planner
from .aggregation import CodeCounts
from .tzp import (FUSED_BOUNDS, ZoneBatch, ZoneBatchLayout, concat_layout,
                  pad_zone_arrays)

AGG_MODES = ("auto", "legacy", "hierarchical", "pipelined")

#: Fused single-launch dispatch policy for ``run_layout``: "auto" fuses
#: whenever the backend publishes a bucket-native flat kernel, "on"
#: requires one (erroring otherwise), "off" keeps the per-bucket path.
FUSED_MODES = ("auto", "on", "off")


def resolve_device(device=None) -> torch.device:
    """The device a run uses: ``device`` when given, else CUDA.

    Raises ``RuntimeError`` when the run would use CUDA (no device asked
    for, or a CUDA device asked for) and PyTorch sees no CUDA device — a
    run never carries on on the CPU unasked, and fails here rather than
    at its first tensor.
    """
    resolved = torch.device("cuda" if device is None else device)
    if resolved.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on "
            "the CPU")
    return resolved


class RunOutcome(NamedTuple):
    """A layout run's result plus the stats of the dispatch that made it."""

    counts: CodeCounts
    stats: dict


class MultiRunOutcome(NamedTuple):
    """A co-mined layout run: one count table per lattice member config."""

    counts: tuple          # tuple[CodeCounts, ...], aligned with params
    stats: dict


class ZoneChunkError(ValueError):
    """Zone count does not divide ``zone_chunk`` under pad_policy='raise'."""


class ZoneOverflowError(RuntimeError):
    """The zone batch dropped edges (``ZoneBatch.overflow > 0``).

    Counts mined from such a batch undercount silently; the executor
    refuses to run unless the caller opts in with ``allow_overflow=True``
    (which still warns).
    """


def _n_chunks(z: int, zone_chunk: int) -> int:
    if z % zone_chunk != 0:
        raise ZoneChunkError(
            f"zone count {z} is not divisible by zone_chunk "
            f"{zone_chunk}; pad the batch (pad_policy='pad') or pick a "
            f"divisor — remainder zones would otherwise be dropped"
        )
    return z // zone_chunk


def _grown_cap(cap: int, n_spilled: int, ceiling: int) -> int:
    """The next merge cap after a spill: at least doubled, a power of two,
    at most ``ceiling`` (a cap that provably cannot spill)."""
    need = max(2 * cap, cap + n_spilled, 8)
    return min(1 << (need - 1).bit_length(), ceiling)


def merge_partial_counts(parts, *, merge_cap: int | None = None,
                         warn_label: str = "partial",
                         obs=None) -> CodeCounts:
    """Fold per-bucket (or per-shard) count tables through
    ``merge_bounded``.

    Partial tables stream through one bounded-width carry instead of one
    unbounded concat-and-sort.  ``merge_cap`` seeds the carry width; a
    spill is detected exactly and retried with a doubled cap, capped at
    the provably sufficient ceiling (total live rows + 1 slot for the
    all-zero padding group), so the result is always exact.
    """
    obs = get_obs(obs)
    parts = list(parts)
    if not parts:
        raise ValueError("merge_partial_counts needs at least one table")
    if len(parts) == 1:
        return parts[0]
    limbs = int(parts[0].codes.shape[1])
    device = parts[0].codes.device
    ceiling = sum(int(p.unique_mask.sum()) for p in parts) + 1
    cap = min(int(merge_cap), ceiling) if merge_cap else ceiling
    cap = max(cap, 8)
    with obs.tracer.span("mine.fold", parts=len(parts)) as sp:
        while True:
            carry = aggregation.empty_counts(cap, limbs, device=device)
            spilled = torch.zeros((), dtype=torch.int32, device=device)
            for part in parts:
                carry, spill = aggregation.merge_bounded(carry, part, cap=cap)
                spilled = spilled + spill
            n_spilled = int(spilled)
            if n_spilled == 0:
                sp.set(merge_cap=cap).sync(carry)
                return carry
            new_cap = _grown_cap(cap, n_spilled, ceiling)
            warnings.warn(
                f"{warn_label} merge spilled {n_spilled} unique code(s) at "
                f"merge_cap={cap}; retrying with merge_cap={new_cap}",
                RuntimeWarning, stacklevel=3,
            )
            obs.metrics.counter("repro_mining_spill_retries_total",
                                path="fold").inc()
            cap = new_cap


def _derive_member(code, length, ts, *, d_i, l_i, delta, l_max):
    """A member config's ``(code, length)`` view of the dominating sweep.

    The dominating member is the sweep itself; every smaller ``(delta,
    l_max)`` is the timestamp-gap prefix truncation
    (:func:`repro_torch.core.expansion.derive_lengths` +
    :func:`repro_torch.core.encoding.truncate_codes`) — lossless because
    zone streams are time-sorted.
    """
    if (d_i, l_i) == (delta, l_max):
        return code, length
    len_i = expansion.derive_lengths(length, ts, delta=d_i, l_max=l_i)
    return encoding.truncate_codes(code, len_i), len_i


def fold_fused(code, length, sign, *, fold_chunk: int, merge_cap: int,
               ts=None, member=None):
    """Phase-2 fold of a fused scan's output, on its device.

    Candidates weigh their slot's zone sign where they hold a process
    (``length > 0``); weighted codes stream through ``count_codes`` +
    ``merge_bounded`` in ``fold_chunk``-row slices.  ``member = (delta_i,
    l_max_i, delta, l_max)`` folds that co-mined member's view instead,
    derived per slice from the sweep's timestamps ``ts``.  Returns
    ``(CodeCounts[merge_cap], spilled)`` with ``spilled`` an int32 scalar
    tensor (0 = exact).
    """
    s, limbs = code.shape
    counts = aggregation.empty_counts(merge_cap, limbs, device=code.device)
    spilled = torch.zeros((), dtype=torch.int32, device=code.device)
    for i in range(s // fold_chunk):
        sl = slice(i * fold_chunk, (i + 1) * fold_chunk)
        c, n = code[sl], length[sl]
        if member is not None:
            d_i, l_i, delta, l_max = member
            c, n = _derive_member(c, n, ts[sl], d_i=d_i, l_i=l_i,
                                  delta=delta, l_max=l_max)
        w = (n > 0).to(torch.int32) * sign[sl]
        part = aggregation.count_codes(torch.where(w[:, None] != 0, c, 0),
                                       w)
        counts, spill = aggregation.merge_bounded(counts, part,
                                                  cap=merge_cap)
        spilled = spilled + spill
    return counts, spilled


class MiningExecutor:
    """Scan + aggregate engine over zone layouts and padded zone batches.

    Args:
      delta, l_max: paper parameters (Definitions 2-5).
      backend: registry name ("ref", "cuda", "torch", "numpy", or plugin).
      zone_chunk: scan a zone batch in chunks of this many zones (None =
        backend hint or budget-derived, 0 = whole batch at once).
      pad_policy: "pad" appends inert zero-sign zone rows when the zone
        count does not divide ``zone_chunk``; "raise" errors instead.
      agg: Phase-2 aggregation mode of the per-bucket path — "auto",
        "legacy", "hierarchical" or "pipelined" (see module docstring).
      merge_cap: bounded-merge carry width (None = backend hint, else one
        chunk's candidate rows; on the fused path one fold chunk's rows,
        at least 1024).  Spills are detected exactly and retried with a
        doubled cap.
      memory_budget_mb: derive ``zone_chunk``/``merge_cap`` (per bucket)
        and the fused ``fold_chunk`` from this device-memory budget via
        :mod:`repro_torch.core.planner`, whenever ``zone_chunk`` was not
        given explicitly.
      fused: single-launch dispatch policy for :meth:`run_layout` —
        "auto" fuses whenever the resolved fused backend publishes a flat
        scan, "on" requires one, "off" keeps the per-bucket path.  A
        per-call ``run_layout(fused=...)`` beats it.
      fused_backend: which backend's flat scan serves fused runs — "auto"
        keeps this executor's backend, except that an accelerator backend
        on a CPU device hands over to the plain ``torch`` scan; an
        explicit registry name pins it.
      fused_bounds: sweep-bound planning for the fused flat stream —
        "live" (default) tightens each candidate block's ``[lo, hi)``
        window to the Lemma-4.1 horizon cut, "full" sweeps to each
        block's zone end.  Output-identical.
      device: where the run's tensors live (see :func:`resolve_device`).

    :meth:`run_layout`/:meth:`run_fused` return a :class:`RunOutcome`
    whose ``stats`` describes the dispatch: ``path`` ("fused", or
    ``fused_<name>`` when the fused scan came from another backend than
    the executor's, e.g. "fused_torch" on a CPU device; "per-bucket"; and
    their ``-multi`` co-mine variants), ``launches`` (1 fused, one per
    bucket otherwise) and ``spill_retries`` (merge-cap doublings).
    """

    def __init__(
        self,
        *,
        delta: int,
        l_max: int,
        backend: str = "ref",
        zone_chunk: int | None = None,
        pad_policy: str = "pad",
        agg: str = "auto",
        merge_cap: int | None = None,
        memory_budget_mb: float | None = None,
        fused: str = "auto",
        fused_backend: str = "auto",
        fused_bounds: str = "live",
        device=None,
        obs=None,
    ):
        if pad_policy not in ("pad", "raise"):
            raise ValueError(f"unknown pad_policy {pad_policy!r}")
        if agg not in AGG_MODES:
            raise ValueError(f"unknown agg mode {agg!r}; one of {AGG_MODES}")
        if fused not in FUSED_MODES:
            raise ValueError(
                f"unknown fused mode {fused!r}; one of {FUSED_MODES}")
        if fused_bounds not in FUSED_BOUNDS:
            raise ValueError(
                f"unknown fused bounds {fused_bounds!r}; one of "
                f"{FUSED_BOUNDS}")
        if fused_backend != "auto" and \
                not backends.get_backend(fused_backend).supports_fused:
            raise ValueError(
                f"fused_backend {fused_backend!r} has no fused "
                f"single-launch scan; pick one that publishes a flat "
                f"kernel (or leave it 'auto')")
        self.device = resolve_device(device)
        self.delta = int(delta)
        self.l_max = int(l_max)
        self.spec = backends.get_backend(backend)
        # an explicit zone_chunk=0 means "unchunked, full batch" (the
        # sequential baseline's contract) and must beat a budget-derived
        # chunk; only None falls through to the backend hint / planner
        self._zone_chunk_explicit = zone_chunk is not None
        if zone_chunk is None:
            zone_chunk = self.spec.default_zone_chunk
        self.zone_chunk = int(zone_chunk or 0)
        self.pad_policy = pad_policy
        self.agg = agg
        self.merge_cap = int(merge_cap) if merge_cap else None
        self.memory_budget_mb = memory_budget_mb
        self.fused = fused
        self.fused_backend = fused_backend
        self.fused_bounds = fused_bounds
        self.fused_blk = backends.FUSED_BLK_DEFAULT
        self._plan_cache: dict[tuple, object] = {}
        # spill-adapted fused merge caps, keyed by fold_chunk: once a
        # fused run spills and retries at a larger cap, later runs with
        # the same fold geometry start from that cap directly.  Only
        # consulted when no explicit merge_cap pins the table size.
        self._fused_cap_adapt: dict[int, int] = {}
        self.obs = get_obs(obs)

    @classmethod
    def from_config(cls, config, *, device=None,
                    obs=None) -> "MiningExecutor":
        """Build an executor from a
        :class:`repro_torch.core.config.MiningConfig` (duck-typed)."""
        return cls(
            delta=config.delta, l_max=config.l_max, backend=config.backend,
            zone_chunk=config.zone_chunk, agg=config.agg,
            merge_cap=config.merge_cap,
            memory_budget_mb=config.memory_budget_mb,
            fused=getattr(config, "fused", "auto"),
            fused_backend=getattr(config, "fused_backend", "auto"),
            device=device, obs=obs,
        )

    @property
    def backend(self) -> str:
        return self.spec.name

    def execution_key(self, z: int, e: int) -> tuple:
        """The key a ``[z, e]`` zone batch resolves to: chunk size from
        the raw shape, zone padding, then the agg mode and merge cap from
        the padded shape — the same resolution :meth:`run_arrays`
        performs, and the JAX package's compile-cache key."""
        zc = self._zone_chunk_for(z, e)
        if zc and zc < z and z % zc != 0:
            z += zc - z % zc
        mode = self._agg_mode_for(zc, z)
        merge_cap = (self._merge_cap_for(zc, z, e)
                     if mode != "legacy" else 0)
        return (self.backend, self.delta, self.l_max, z, e, zc, mode,
                merge_cap)

    # -- capacity resolution ------------------------------------------------

    def capacity_plan(self, n_zones: int, e_cap: int):
        """Budget-derived :class:`~repro_torch.core.planner.CapacityPlan`,
        or None when no ``memory_budget_mb`` was configured; memoized per
        ``(n_zones, e_cap)``."""
        if self.memory_budget_mb is None:
            return None
        key = (n_zones, e_cap)
        plan = self._plan_cache.get(key)
        if plan is None:
            plan = planner.plan_capacity(
                n_zones=n_zones, e_cap=e_cap, l_max=self.l_max,
                memory_budget_mb=self.memory_budget_mb,
                mem_model=self.spec.mem_model, merge_cap=self.merge_cap,
            )
            self._plan_cache[key] = plan
        return plan

    def _zone_chunk_for(self, z: int, e: int) -> int:
        if self.zone_chunk:
            return self.zone_chunk
        if self._zone_chunk_explicit:
            return 0           # explicitly unchunked: never consult a budget
        plan = self.capacity_plan(z, e)
        if plan is None:
            return 0
        return plan.zone_chunk if plan.zone_chunk < z else 0

    def _merge_cap_for(self, zc: int, z: int, e: int) -> int:
        if self.merge_cap:
            return self.merge_cap
        if self.spec.default_merge_cap:
            return self.spec.default_merge_cap
        return planner.default_merge_cap(zc or z, e)

    def _agg_mode_for(self, zc: int, z: int) -> str:
        if self.agg != "auto":
            return self.agg
        return "hierarchical" if zc and zc < z else "legacy"

    # -- the per-bucket scan and fold ---------------------------------------

    def _scan(self, u, v, t, valid, *, with_ts: bool = False):
        """The backend's scan of one ``[Z, E]`` chunk; outputs on the
        executor's device (a host-only backend's numpy results are moved
        there)."""
        kw = {"with_ts": True} if with_ts else {}
        res = self.spec.scan(u, v, t, valid, delta=self.delta,
                             l_max=self.l_max, **kw)
        if self.spec.host_only:
            res = expansion.ZoneResult(*(
                None if x is None else torch.as_tensor(x, device=self.device)
                for x in res))
        return res

    def _chunks(self, arrays, zc: int, *, pipelined: bool = False):
        """Yield ``(u, v, t, valid, signs)`` per chunk of ``zc`` zones.

        ``u, v, t, valid`` lie where the backend's scan reads them (numpy
        on the host for a host-only backend, else on the device); ``signs``
        always on the device, where the fold runs.  ``pipelined`` copies
        each next chunk ahead (see :meth:`_prefetched`).
        """
        z = arrays[0].shape[0]
        zc = zc if (zc and zc < z) else z
        nchunk = _n_chunks(z, zc) if z else 0
        if self.spec.host_only:
            signs = torch.as_tensor(arrays[4], device=self.device)
            for i in range(nchunk):
                sl = slice(i * zc, (i + 1) * zc)
                yield (*(np.asarray(x)[sl] for x in arrays[:4]), signs[sl])
        elif pipelined:
            yield from self._prefetched(arrays, zc, nchunk)
        else:
            tensors = [torch.as_tensor(x, device=self.device)
                       for x in arrays]
            for i in range(nchunk):
                sl = slice(i * zc, (i + 1) * zc)
                yield tuple(x[sl] for x in tensors)

    def _prefetched(self, arrays, zc: int, nchunk: int):
        """Chunks copied host to device one ahead of the compute.

        On CUDA the host arrays are pinned and each chunk is copied on a
        side stream; the compute stream waits on that copy's event before
        it scans the chunk, and the copied tensors are recorded on the
        compute stream, so the allocator frees no buffer the compute
        still reads.  Chunk ``i + 1``'s copy is issued before chunk ``i``
        is handed to the fold, so it overlaps chunk ``i``'s scan.  On the
        CPU it is the same loop with no streams.
        """
        dev = self.device
        host = [torch.from_numpy(np.ascontiguousarray(x)) for x in arrays]
        if dev.type != "cuda":
            for i in range(nchunk):
                sl = slice(i * zc, (i + 1) * zc)
                yield tuple(x[sl].to(dev) for x in host)
            return
        host = [x.pin_memory() for x in host]
        side = torch.cuda.Stream(device=dev)
        compute = torch.cuda.current_stream(dev)

        def put(i):
            sl = slice(i * zc, (i + 1) * zc)
            with torch.cuda.stream(side):
                chunk = tuple(x[sl].to(dev, non_blocking=True)
                              for x in host)
                copied = torch.cuda.Event()
                copied.record(side)
            return chunk, copied

        nxt = put(0) if nchunk else None
        for i in range(nchunk):
            chunk, copied = nxt
            compute.wait_event(copied)
            for x in chunk:
                x.record_stream(compute)
            if i + 1 < nchunk:
                nxt = put(i + 1)
            yield chunk

    def _hier_fold(self, chunks, params, caps, *, with_ts: bool):
        """Scan each chunk and fold it into one bounded carry per member.

        ``params`` holds ``(delta_i, l_max_i)`` members (the executor's own
        config alone for a single-config run); each member's view of the
        chunk (:func:`_derive_member`) is signed-counted and merged into
        its ``caps[i]``-row carry, so at no point do all ``Z*C`` candidate
        codes coexist.  Returns ``[(CodeCounts, spilled)]`` per member.
        """
        limbs = encoding.n_limbs(self.l_max)
        dev = self.device
        tracer = self.obs.tracer
        carries = [(aggregation.empty_counts(cap, limbs, device=dev),
                    torch.zeros((), dtype=torch.int32, device=dev))
                   for cap in caps]
        for cu, cv, ct, cvalid, csigns in chunks:
            with tracer.span("mine.scan", device=dev, zones=cu.shape[0]):
                res = self._scan(cu, cv, ct, cvalid, with_ts=with_ts)
            # each member counts its chunk, then the chunk's table with
            # its carry
            slots = res.length.numel()
            rows = sum(2 * slots + cap for cap in caps)
            with tracer.span("mine.fold", device=dev, rows=rows):
                for i, ((d_i, l_i), cap) in enumerate(zip(params, caps)):
                    code_i, len_i = _derive_member(
                        res.code, res.length, res.ts, d_i=d_i, l_i=l_i,
                        delta=self.delta, l_max=self.l_max)
                    part = aggregation.aggregate_zones(code_i, len_i,
                                                       csigns)
                    carry, spilled = carries[i]
                    merged, spill = aggregation.merge_bounded(carry, part,
                                                              cap=cap)
                    carries[i] = (merged, spilled + spill)
            self._count_rows(rows)
        return carries

    def _count_rows(self, rows: int) -> None:
        """Rows entering this rank's signed counts (its fold)."""
        if self.obs.enabled:
            self.obs.metrics.counter("repro_mining_rows_counted_total",
                                     stage="rank").inc(rows)

    def _run_legacy(self, arrays, zc: int) -> CodeCounts:
        """Scan every chunk, then one whole-batch signed count."""
        dev = self.device
        tracer = self.obs.tracer
        codes, lengths, signs = [], [], []
        with tracer.span("mine.scan", device=dev, zones=arrays[0].shape[0]):
            for cu, cv, ct, cvalid, csigns in self._chunks(arrays, zc):
                res = self._scan(cu, cv, ct, cvalid)
                codes.append(res.code)
                lengths.append(res.length)
                signs.append(csigns)
        rows = sum(x.numel() for x in lengths)
        with tracer.span("mine.fold", device=dev, rows=rows):
            counts = aggregation.aggregate_zones(
                torch.cat(codes), torch.cat(lengths), torch.cat(signs))
        self._count_rows(rows)
        return counts

    def _run_bounded(self, arrays, zc: int, *, pipelined: bool = False,
                     params=None):
        """Hierarchical/pipelined fold with the merge-cap spill policy.

        ``params`` (co-mining) folds one ``with_ts`` sweep into a carry per
        member.  Returns ``(counts tuple, spill retries)``.  Spills are
        exact signals, so re-running the bucket with a doubled cap is
        lossless; ``merge_cap >= z*e + 1`` can never spill (at most z*e
        distinct live codes, plus one row for the all-zero padding group),
        so the loop ends.
        """
        z, e = arrays[0].shape
        cap_ceiling = z * e + 1
        multi = params is not None
        members = params if multi else ((self.delta, self.l_max),)
        caps = [min(self._merge_cap_for(zc, z, e), cap_ceiling)] * len(
            members)
        retries = 0
        while True:
            out = self._hier_fold(
                self._chunks(arrays, zc, pipelined=pipelined), members,
                caps, with_ts=multi)
            spills = [int(sp) for _, sp in out]
            if not any(spills):
                return tuple(c for c, _ in out), retries
            old = list(caps)
            caps = [_grown_cap(cap, n, cap_ceiling) if n else cap
                    for cap, n in zip(caps, spills)]
            if multi:
                msg = (f"co-mine hierarchical merge spilled {spills} unique "
                       f"code(s) across {len(params)} member config(s); "
                       f"retrying with merge_caps={caps}")
            else:
                msg = (f"hierarchical merge spilled {spills[0]} unique "
                       f"code(s) at merge_cap={old[0]}; retrying with "
                       f"merge_cap={caps[0]}")
            warnings.warn(msg, RuntimeWarning, stacklevel=3)
            self.obs.metrics.counter(
                "repro_mining_spill_retries_total",
                path="bucket-multi" if multi else "bucket").inc()
            retries += 1

    # -- plain cores (sharded mining runs them on each shard) ---------------

    def _require_device_scan(self):
        if self.spec.host_only:
            raise ValueError(
                f"backend {self.backend!r} is host-only and cannot run "
                f"inside a sharded computation")

    def scan_aggregate(self, u, v, t, valid, signs) -> CodeCounts:
        """Scan + whole-batch signed count of a ``[Z, E]`` batch already
        on the device.  Always the legacy (lossless-by-construction)
        aggregation; raises :class:`ZoneChunkError` when the zone count
        does not divide ``zone_chunk``."""
        self._require_device_scan()
        return self._run_legacy((u, v, t, valid, signs), self.zone_chunk)

    def scan_aggregate_partial(self, u, v, t, valid, signs):
        """Scan + aggregate honoring the executor's ``agg`` mode, one
        pass and no retry.

        Returns ``(CodeCounts, spilled)``: ``spilled`` is an int32 scalar
        tensor, 0 whenever the result is exact; positive means the
        bounded carry overflowed ``merge_cap`` and the caller must re-run
        with a larger cap instead of silently undercounting.
        """
        self._require_device_scan()
        z, e = u.shape
        zc = self._zone_chunk_for(z, e)
        if self._agg_mode_for(zc, z) == "legacy":
            return (self.scan_aggregate(u, v, t, valid, signs),
                    torch.zeros((), dtype=torch.int32, device=self.device))
        [out] = self._hier_fold(
            self._chunks((u, v, t, valid, signs), zc),
            ((self.delta, self.l_max),), [self._merge_cap_for(zc, z, e)],
            with_ts=False)
        return out

    # -- host-level entry points -------------------------------------------

    @staticmethod
    def check_batch_overflow(batch: ZoneBatch, *,
                             allow_overflow: bool = False) -> None:
        """Raise :class:`ZoneOverflowError` when the batch dropped edges
        (``batch.overflow > 0``); ``allow_overflow=True`` warns instead."""
        if not batch.overflow:
            return
        where = f" (bucket {batch.label!r})" if batch.label else ""
        msg = (f"zone batch{where} dropped {batch.overflow} edge(s) that "
               f"exceeded e_cap={batch.e_cap}; counts would silently "
               f"undercount (raise e_cap, or shrink zones by planning "
               f"with e_cap / a memory budget)")
        if not allow_overflow:
            raise ZoneOverflowError(msg)
        warnings.warn(msg + " — continuing because allow_overflow=True",
                      RuntimeWarning, stacklevel=3)

    @staticmethod
    def check_layout_overflow(layout: ZoneBatchLayout, *,
                              allow_overflow: bool = False) -> None:
        """One overflow policy across every bucket of a layout, naming
        each offending bucket."""
        bad = [b for b in layout.buckets if b.overflow]
        if not bad:
            return
        detail = ", ".join(
            f"{b.label or 'dense'}: {b.overflow} edge(s) beyond "
            f"e_cap={b.e_cap}" for b in bad)
        msg = (f"zone layout dropped {layout.overflow} edge(s) across "
               f"{len(bad)} bucket(s) [{detail}]; counts would silently "
               f"undercount (raise e_cap, or shrink zones by planning "
               f"with e_cap / a memory budget)")
        if not allow_overflow:
            raise ZoneOverflowError(msg)
        warnings.warn(msg + " — continuing because allow_overflow=True",
                      RuntimeWarning, stacklevel=3)

    def run(self, batch: ZoneBatch, *, allow_overflow: bool = False
            ) -> CodeCounts:
        """Mine a host-built :class:`ZoneBatch` to signed code counts.

        Applies :meth:`check_batch_overflow` first — overflowed batches
        raise unless ``allow_overflow=True``.
        """
        self.check_batch_overflow(batch, allow_overflow=allow_overflow)
        return self.run_arrays(batch.u, batch.v, batch.t, batch.valid,
                               batch.sign, label=batch.label)

    def _pad_for_chunks(self, arrays, label: str):
        """Resolve the zone chunk of a host batch and apply the pad
        policy; returns ``(arrays, zone_chunk)``."""
        z, e = arrays[0].shape
        zc = self._zone_chunk_for(z, e)
        if zc and zc < z and z % zc != 0:
            if self.pad_policy == "raise":
                where = f" in bucket {label!r}" if label else ""
                raise ZoneChunkError(
                    f"zone count {z}{where} is not divisible by "
                    f"zone_chunk {zc} (pad_policy='raise'); the "
                    f"trailing {z % zc} zone(s) would need inert "
                    f"padding rows — pad the batch (pad_policy='pad') "
                    f"or pick a divisor"
                )
            arrays = pad_zone_arrays(*arrays, n_rows=z + (zc - z % zc))
        return arrays, zc

    def run_arrays(self, u, v, t, valid, signs, *,
                   label: str = "") -> CodeCounts:
        """Mine raw [Z, E] zone arrays (+ [Z] signs) to signed code counts."""
        arrays = tuple(np.asarray(x) for x in (u, v, t, valid, signs))
        z, e = arrays[0].shape
        ck = self.execution_key(z, e) if self.obs.enabled else None
        with self.obs.tracer.span("mine.launch", z=z, e=e, label=label,
                                  compile_key=ck) as sp:
            arrays, zc = self._pad_for_chunks(arrays, label)
            mode = self._agg_mode_for(zc, arrays[0].shape[0])
            sp.set(agg=mode, zone_chunk=zc)
            if mode == "legacy":
                counts = self._run_legacy(arrays, zc)
            else:
                (counts,), _ = self._run_bounded(
                    arrays, zc, pipelined=mode == "pipelined")
            sp.sync(counts)
            return counts

    def _fused_spec(self) -> backends.BackendSpec:
        """The backend whose flat scan serves this executor's fused runs.

        An explicit ``fused_backend`` pins it (validated at construction).
        ``"auto"`` keeps this executor's own backend, except when that
        backend is an accelerator kernel and the device is the CPU: a
        kernel needs CUDA tensors, so the plain ``torch`` scan serves —
        the counterpart of the JAX package's reroute to its compiled
        lowering on hosts without a compiled kernel.
        """
        if self.fused_backend != "auto":
            return backends.get_backend(self.fused_backend)
        spec = self.spec
        if spec.supports_fused and spec.grade == "accelerator" \
                and self.device.type == "cpu":
            return backends.get_backend("torch")
        return spec

    def _fused_path(self, suffix: str = "") -> str:
        """Stats ``path`` label: "fused" when the executor's own backend
        ran the scan, "fused_<name>" when dispatch rerouted it."""
        fspec = self._fused_spec()
        base = "fused" if fspec.name == self.backend else \
            f"fused_{fspec.name}"
        return base + suffix

    def resolve_fused(self, fused: bool | None = None) -> bool:
        """Resolve the fused-dispatch decision for a layout run.

        A per-call boolean beats the constructor policy; ``True`` (or
        policy "on") when no fused scan resolves raises rather than
        silently taking another path.
        """
        if fused is None:
            if self.fused == "off":
                return False
            if self.fused == "auto":
                return self._fused_spec().supports_fused
            fused = True
        if fused and not self._fused_spec().supports_fused:
            raise ValueError(
                f"backend {self.backend!r} has no fused single-launch "
                f"scan; use fused=False (or fused='off') for the "
                f"per-bucket path, or pick a fused_backend that has one")
        return bool(fused)

    def run_layout(self, layout: ZoneBatchLayout, *,
                   allow_overflow: bool = False,
                   fused: bool | None = None) -> RunOutcome:
        """Mine a :class:`ZoneBatchLayout` (dense or bucketed) exactly.

        Dispatch is decided by :meth:`resolve_fused`: the fused path
        (:meth:`run_fused`) mines the whole layout in one launch; the
        per-bucket path runs each bucket through :meth:`run_arrays` with
        its own shape — and hence its own budget-derived
        ``zone_chunk``/``merge_cap`` — then folds the per-bucket tables
        through :func:`merge_partial_counts`.  Lemma 4.2's signed sum is
        associative over zones, so either split is exact.
        """
        if self.resolve_fused(fused):
            return self.run_fused(layout, allow_overflow=allow_overflow)
        self.check_layout_overflow(layout, allow_overflow=allow_overflow)
        with self.obs.tracer.span("mine.layout", path="per-bucket",
                                  buckets=layout.n_buckets):
            parts = [
                self.run_arrays(b.u, b.v, b.t, b.valid, b.sign,
                                label=b.label)
                for b in layout.buckets
            ]
            stats = {
                "path": "per-bucket",
                "launches": len(layout.buckets),
                "spill_retries": 0,
            }
            self.obs.metrics.counter(
                "repro_mining_launches_total",
                path="per-bucket").inc(len(layout.buckets))
            counts = merge_partial_counts(parts, merge_cap=self.merge_cap,
                                          warn_label="zone-layout bucket",
                                          obs=self.obs)
            return RunOutcome(counts=counts, stats=stats)

    # -- fused single-launch path -------------------------------------------

    def _fused_geometry(self, layout: ZoneBatchLayout) -> tuple[int, int, int]:
        """``(blk, fold_chunk, n_slots_padded)`` for a layout's fused run.

        Derivable from bucket shapes alone (no arrays built); must agree
        with :func:`repro_torch.core.tzp.concat_layout`'s padding rule.
        """
        blk = self.fused_blk
        real_slots = sum(b.n_real_zones * b.e_cap for b in layout.buckets)
        if self.memory_budget_mb is not None:
            key = ("fused", real_slots)
            plan = self._plan_cache.get(key)
            if plan is None:
                plan = planner.plan_fused_capacity(
                    n_slots=real_slots, l_max=self.l_max,
                    memory_budget_mb=self.memory_budget_mb, blk=blk,
                    merge_cap=self.merge_cap,
                )
                self._plan_cache[key] = plan
            fold_chunk = plan.fold_chunk
        else:
            fold_chunk = planner.default_fold_chunk(real_slots, blk=blk)
        mult = fold_chunk
        s_pad = max(-(-max(real_slots, 1) // mult) * mult, mult)
        return blk, fold_chunk, s_pad

    def fused_layout(self, layout: ZoneBatchLayout):
        """``(FusedZoneLayout, fold_chunk)``: the flat slot stream a fused
        run of ``layout`` sweeps (padded to its fold chunk, with this
        executor's sweep bounds) and the fold chunk it folds in."""
        blk, fold_chunk, _ = self._fused_geometry(layout)
        with self.obs.tracer.span("mine.flatten", zones=layout.n_zones,
                                  buckets=layout.n_buckets) as sp:
            fl = concat_layout(layout, blk=blk, pad_slots_to=fold_chunk,
                               delta=self.delta, l_max=self.l_max,
                               bounds=self.fused_bounds)
            sp.set(n_slots=fl.n_slots)
        return fl, fold_chunk

    def fused_merge_cap(self, fl, fold_chunk: int) -> int:
        """The merge cap a fused run of ``fl`` starts its fold with."""
        return min(self._fused_merge_cap(fold_chunk), fl.n_slots + 1)

    def _fused_merge_cap(self, fold_chunk: int) -> int:
        if self.merge_cap:
            return self.merge_cap
        base = self.spec.default_merge_cap or max(1024, fold_chunk)
        return max(base, self._fused_cap_adapt.get(fold_chunk, 0))

    def _note_fused_cap(self, fold_chunk: int, cap: int,
                        retries: int) -> None:
        """Remember a spill-adapted cap so the NEXT run starts there."""
        if retries and not self.merge_cap:
            prev = self._fused_cap_adapt.get(fold_chunk, 0)
            self._fused_cap_adapt[fold_chunk] = max(prev, cap)

    def fused_execution_key(self, layout: ZoneBatchLayout) -> tuple:
        """The key a fused layout run resolves to (the JAX package's
        compile-cache key of its fused executable): the flat stream and
        fold geometry, the resolved fused backend and the sweep bounds."""
        blk, fold_chunk, s_pad = self._fused_geometry(layout)
        merge_cap = min(self._fused_merge_cap(fold_chunk), s_pad + 1)
        return ("fused", self.backend, self._fused_spec().name,
                self.fused_bounds, self.delta, self.l_max, s_pad, blk,
                fold_chunk, merge_cap)

    def _fused_inputs(self, fl):
        """The flat stream's tensors on the device, timed as one span."""
        with self.obs.tracer.span("mine.h2d", n_slots=fl.n_slots) as sp:
            tensors = [torch.as_tensor(x, device=self.device) for x in (
                fl.u, fl.v, fl.t, fl.valid, fl.zone_id, fl.sign, fl.lo,
                fl.hi)]
            sp.sync(tensors[0])
        return tensors

    def run_fused(self, layout: ZoneBatchLayout, *,
                  allow_overflow: bool = False) -> RunOutcome:
        """Mine a layout in ONE kernel launch, fold on the device.

        The layout is flattened to a :class:`~repro_torch.core.tzp.
        FusedZoneLayout` slot stream (real zone rows only, padded to the
        fold chunk) and handed to the fused scan; :func:`fold_fused` then
        reduces its codes to a bounded count table.  Only that table and
        the spill counter come back; a spill re-folds with a doubled cap
        (ceiling ``n_slots + 1``, which provably cannot spill).
        """
        self.check_layout_overflow(layout, allow_overflow=allow_overflow)
        obs = self.obs
        fspec = self._fused_spec()
        path = self._fused_path()
        fl, fold_chunk = self.fused_layout(layout)
        blk = fl.blk
        cap_ceiling = fl.n_slots + 1
        merge_cap = self.fused_merge_cap(fl, fold_chunk)
        u, v, t, valid, zone_id, sign, lo, hi = self._fused_inputs(fl)
        with obs.tracer.span("mine.scan", n_slots=fl.n_slots,
                             backend=fspec.name) as sp:
            code, length = fspec.fused_scan(
                u, v, t, valid, zone_id, lo, hi, delta=self.delta,
                l_max=self.l_max, blk=blk)
            sp.sync(code)
        retries = 0
        while True:
            ck = ("fused", self.backend, fspec.name, str(self.device),
                  fl.bounds, self.delta, self.l_max, fl.n_slots, blk,
                  fold_chunk, merge_cap) if obs.enabled else None
            with obs.tracer.span("mine.fold", merge_cap=merge_cap,
                                 retry=retries, compile_key=ck) as sp:
                counts, spilled = fold_fused(
                    code, length, sign, fold_chunk=fold_chunk,
                    merge_cap=merge_cap)
                sp.sync((counts, spilled))
            with obs.tracer.span("mine.d2h"):
                n_spilled = int(spilled)
            if n_spilled == 0:
                self._note_fused_cap(fold_chunk, merge_cap, retries)
                stats = {
                    "path": path,
                    "backend": fspec.name,
                    "bounds": fl.bounds,
                    "launches": 1,
                    "spill_retries": retries,
                    "merge_cap": merge_cap,
                    "fold_chunk": fold_chunk,
                    "n_slots": fl.n_slots,
                    "sweep_slots": fl.sweep_slots,
                }
                obs.metrics.counter("repro_mining_launches_total",
                                    path=path).inc()
                m = obs.metrics
                m.gauge("repro_mining_fused_merge_cap").set(merge_cap)
                m.gauge("repro_mining_fused_fold_chunk").set(fold_chunk)
                m.gauge("repro_mining_fused_slots").set(fl.n_slots)
                m.gauge("repro_mining_fused_sweep_slots").set(fl.sweep_slots)
                return RunOutcome(counts=counts, stats=stats)
            new_cap = _grown_cap(merge_cap, n_spilled, cap_ceiling)
            warnings.warn(
                f"fused on-device merge spilled {n_spilled} unique code(s) "
                f"at merge_cap={merge_cap}; retrying with "
                f"merge_cap={new_cap}",
                RuntimeWarning, stacklevel=3,
            )
            obs.metrics.counter("repro_mining_spill_retries_total",
                                path="fused").inc()
            merge_cap = new_cap
            retries += 1

    def layout_execution_keys(self, layout: ZoneBatchLayout,
                              fused: bool | None = None) -> tuple:
        """Execution keys a layout run resolves to: one
        :meth:`execution_key` per bucket on the per-bucket path, one
        :meth:`fused_execution_key` on the fused path."""
        if self.resolve_fused(fused):
            return (self.fused_execution_key(layout),)
        return tuple(self.execution_key(b.n_zones, b.e_cap)
                     for b in layout.buckets)

    # -- config-lattice co-mining --------------------------------------------

    def _check_comine_params(self, params) -> tuple:
        params = tuple((int(d), int(l)) for d, l in params)
        if not params:
            raise ValueError("co-mine needs at least one (delta, l_max)")
        if not self.spec.supports_comine:
            raise ValueError(
                f"backend {self.backend!r} does not support co-mining "
                f"(its scan has no with_ts timestamp output)")
        for d, l in params:
            if not (1 <= d <= self.delta and 1 <= l <= self.l_max):
                raise ValueError(
                    f"co-mined config (delta={d}, l_max={l}) is not "
                    f"dominated by the sweep config (delta={self.delta}, "
                    f"l_max={self.l_max})")
        return params

    def run_layout_multi(self, layout: ZoneBatchLayout, params, *,
                         allow_overflow: bool = False,
                         fused: bool | None = None) -> MultiRunOutcome:
        """Co-mine N member configs from ONE dominating Phase-1 sweep.

        ``params`` is a sequence of ``(delta_i, l_max_i)`` pairs, each
        dominated by this executor's ``(delta, l_max)``.  The layout is
        swept once per bucket (or once in all, fused) at the dominating
        config with per-step absorption timestamps; each member's table is
        split out during the Phase-2 fold by prefix-truncating candidates
        on those timestamps — byte-identical to mining that member alone.
        Returns one exact :class:`CodeCounts` per param.
        """
        params = self._check_comine_params(params)
        if self.resolve_fused(fused):
            return self.run_fused_multi(layout, params,
                                        allow_overflow=allow_overflow)
        self.check_layout_overflow(layout, allow_overflow=allow_overflow)
        with self.obs.tracer.span("mine.layout", path="per-bucket-multi",
                                  buckets=layout.n_buckets,
                                  n_configs=len(params)):
            parts: list[list[CodeCounts]] = [[] for _ in params]
            retries_total = 0
            for b in layout.buckets:
                bucket_counts, retries = self._run_arrays_multi(
                    b.u, b.v, b.t, b.valid, b.sign, params, label=b.label)
                retries_total += retries
                for member_parts, c in zip(parts, bucket_counts):
                    member_parts.append(c)
            self.obs.metrics.counter(
                "repro_mining_launches_total",
                path="per-bucket-multi").inc(len(layout.buckets))
            counts = tuple(
                merge_partial_counts(p, merge_cap=self.merge_cap,
                                     warn_label="zone-layout bucket",
                                     obs=self.obs)
                for p in parts)
            stats = {
                "path": "per-bucket-multi",
                "launches": len(layout.buckets),
                "spill_retries": retries_total,
                "n_configs": len(params),
            }
            return MultiRunOutcome(counts=counts, stats=stats)

    def run_fused_multi(self, layout: ZoneBatchLayout, params, *,
                        allow_overflow: bool = False) -> MultiRunOutcome:
        """Co-mine a layout in ONE ``with_ts`` kernel launch with N folds.

        A member whose fold spills re-folds the kept kernel output at a
        doubled cap; the launch is not repeated.
        """
        params = self._check_comine_params(params)
        self.check_layout_overflow(layout, allow_overflow=allow_overflow)
        obs = self.obs
        fspec = self._fused_spec()
        path = self._fused_path("-multi")
        fl, fold_chunk = self.fused_layout(layout)
        cap_ceiling = fl.n_slots + 1
        caps = [self.fused_merge_cap(fl, fold_chunk) for _ in params]
        u, v, t, valid, zone_id, sign, lo, hi = self._fused_inputs(fl)
        with obs.tracer.span("mine.scan", n_slots=fl.n_slots,
                             backend=fspec.name, with_ts=True) as sp:
            code, length, ts = fspec.fused_scan(
                u, v, t, valid, zone_id, lo, hi, delta=self.delta,
                l_max=self.l_max, blk=fl.blk, with_ts=True)
            sp.sync(code)
        out = [None] * len(params)
        retries = 0
        while True:
            with obs.tracer.span("mine.fold", n_configs=len(params),
                                 retry=retries) as sp:
                for i, (d_i, l_i) in enumerate(params):
                    if out[i] is None:
                        out[i] = fold_fused(
                            code, length, sign, fold_chunk=fold_chunk,
                            merge_cap=caps[i], ts=ts,
                            member=(d_i, l_i, self.delta, self.l_max))
                sp.sync(out)
            with obs.tracer.span("mine.d2h"):
                spills = [int(sp_i) for _, sp_i in out]
            if not any(spills):
                self._note_fused_cap(fold_chunk, max(caps), retries)
                stats = {
                    "path": path,
                    "backend": fspec.name,
                    "bounds": fl.bounds,
                    "launches": 1,
                    "spill_retries": retries,
                    "merge_caps": tuple(caps),
                    "fold_chunk": fold_chunk,
                    "n_slots": fl.n_slots,
                    "sweep_slots": fl.sweep_slots,
                    "n_configs": len(params),
                }
                obs.metrics.counter("repro_mining_launches_total",
                                    path=path).inc()
                return MultiRunOutcome(
                    counts=tuple(c for c, _ in out), stats=stats)
            for i, n_spilled in enumerate(spills):
                if n_spilled:
                    caps[i] = _grown_cap(caps[i], n_spilled, cap_ceiling)
                    out[i] = None
            warnings.warn(
                f"fused co-mine spilled {spills} unique code(s) across "
                f"{len(params)} member config(s); retrying with "
                f"merge_caps={caps}",
                RuntimeWarning, stacklevel=3,
            )
            obs.metrics.counter("repro_mining_spill_retries_total",
                                path="fused-multi").inc()
            retries += 1

    def _run_arrays_multi(self, u, v, t, valid, signs, params, *,
                          label: str = ""):
        """Co-mine raw [Z, E] zone arrays; returns (counts tuple, retries).

        Mirrors :meth:`run_arrays`'s pad/chunk resolution, but always takes
        the bounded fold — the multi path has no legacy whole-batch mode
        (an unchunked batch is simply one chunk).
        """
        arrays = tuple(np.asarray(x) for x in (u, v, t, valid, signs))
        z, e = arrays[0].shape
        with self.obs.tracer.span("mine.launch", z=z, e=e, label=label,
                                  multi=len(params)) as sp:
            arrays, zc = self._pad_for_chunks(arrays, label)
            sp.set(zone_chunk=zc)
            return self._run_bounded(arrays, zc, params=params)
