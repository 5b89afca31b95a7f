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
* the **zone-batch path** (:meth:`MiningExecutor.run`) mines a padded
  ``[Z, E]`` batch with the backend's per-zone scan and one whole-batch
  signed count (``agg="legacy"``) — the sequential baseline's one-zone
  batch takes it.  Zone chunking (chunks of ``zone_chunk`` zones) bounds
  the scan's working set, with an explicit **pad**/**raise** policy for
  zone counts that do not divide it.

The bounded per-chunk folds of the zone-batch path (``agg="hierarchical"``
and ``"pipelined"``), the per-bucket layout path, and budget-derived zone
chunks are ROADMAP slice 2 and raise ``NotImplementedError`` here.

The executor runs on ``device``: CUDA unless the caller passes
``device="cpu"``; with no CUDA device and no explicit device it raises.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.obs import get_obs

from . import aggregation, backends, planner
from .aggregation import CodeCounts
from .tzp import (FUSED_BOUNDS, ZoneBatch, ZoneBatchLayout, concat_layout,
                  pad_zone_arrays)

AGG_MODES = ("auto", "legacy", "hierarchical", "pipelined")

#: Fused single-launch dispatch policy for ``run_layout``: "auto" fuses
#: whenever the backend publishes a bucket-native flat kernel, "on"
#: requires one (erroring otherwise), "off" keeps the per-bucket path.
FUSED_MODES = ("auto", "on", "off")

_SLICE2 = "ROADMAP slice 2"


def resolve_device(device=None) -> torch.device:
    """The device a run uses: ``device`` when given, else CUDA.

    Raises ``RuntimeError`` when no device was asked for and PyTorch sees
    no CUDA device — a run never carries on on the CPU unasked.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on "
            "the CPU")
    return torch.device("cuda")


class RunOutcome(NamedTuple):
    """A layout run's result plus the stats of the dispatch that made it."""

    counts: CodeCounts
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


def _chunked_scan(scan, u, v, t, valid, *, delta, l_max, zone_chunk):
    """Sweep a [Z, E] zone batch, optionally in chunks of ``zone_chunk``."""
    z = u.shape[0]
    if not (zone_chunk and zone_chunk < z):
        res = scan(u, v, t, valid, delta=delta, l_max=l_max)
        return res.code, res.length
    codes, lengths = [], []
    for i in range(_n_chunks(z, zone_chunk)):
        sl = slice(i * zone_chunk, (i + 1) * zone_chunk)
        res = scan(u[sl], v[sl], t[sl], valid[sl], delta=delta, l_max=l_max)
        codes.append(res.code)
        lengths.append(res.length)
    return torch.cat(codes), torch.cat(lengths)


def fold_fused(code, length, sign, *, fold_chunk: int, merge_cap: int):
    """Phase-2 fold of a fused scan's output, on its device.

    Candidates weigh their slot's zone sign where they hold a process
    (``length > 0``); weighted codes stream through ``count_codes`` +
    ``merge_bounded`` in ``fold_chunk``-row slices.  Returns
    ``(CodeCounts[merge_cap], spilled)`` with ``spilled`` an int32 scalar
    tensor (0 = exact).
    """
    s, limbs = code.shape
    w = (length > 0).to(torch.int32) * sign
    codes = torch.where(w[:, None] != 0, code, 0)
    counts = aggregation.empty_counts(merge_cap, limbs, device=code.device)
    spilled = torch.zeros((), dtype=torch.int32, device=code.device)
    for i in range(s // fold_chunk):
        sl = slice(i * fold_chunk, (i + 1) * fold_chunk)
        part = aggregation.count_codes(codes[sl], w[sl])
        counts, spill = aggregation.merge_bounded(counts, part,
                                                  cap=merge_cap)
        spilled = spilled + spill
    return counts, spilled


class MiningExecutor:
    """Scan + aggregate engine over zone layouts and padded zone batches.

    Args:
      delta, l_max: paper parameters (Definitions 2-5).
      backend: registry name ("ref", "cuda", "torch", or plugin).
      zone_chunk: scan a zone batch in chunks of this many zones (None/0 =
        whole batch at once); defaults to the backend's hint.
      pad_policy: "pad" appends inert zero-sign zone rows when the zone
        count does not divide ``zone_chunk``; "raise" errors instead.
      agg: Phase-2 aggregation mode of the zone-batch path; only
        "legacy" (and "auto" where it resolves to it) is ported.
      merge_cap: bounded-merge carry width of the fused fold (None =
        backend hint, else one fold chunk's rows, at least 1024).  Spills
        are detected exactly and retried with a doubled cap.
      memory_budget_mb: derive the fused ``fold_chunk`` from this device
        memory budget via :mod:`repro_torch.core.planner`.
      fused: single-launch dispatch policy for :meth:`run_layout` —
        "auto" fuses whenever the resolved fused backend publishes a flat
        scan, "on" requires one, "off" asks for the per-bucket path (not
        ported yet).  A per-call ``run_layout(fused=...)`` beats it.
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
    the executor's, e.g. "fused_torch" on a CPU device), ``launches`` (1)
    and ``spill_retries`` (merge-cap doublings, each re-running the fold).
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
        the raw shape, zone padding, then the agg mode from the padded
        shape — the same resolution :meth:`run_arrays` performs."""
        zc = self._zone_chunk_for(z, e)
        if zc and zc < z and z % zc != 0:
            z += zc - z % zc
        mode = self._agg_mode_for(zc, z)
        return (self.backend, self.delta, self.l_max, z, e, zc, mode)

    # -- capacity resolution ------------------------------------------------

    def _zone_chunk_for(self, z: int, e: int) -> int:
        if self.zone_chunk:
            return self.zone_chunk
        if self._zone_chunk_explicit or self.memory_budget_mb is None:
            return 0
        raise NotImplementedError(
            f"budget-derived zone chunks of the zone-batch path are "
            f"{_SLICE2}; pass zone_chunk explicitly")

    def _agg_mode_for(self, zc: int, z: int) -> str:
        if self.agg != "auto":
            return self.agg
        return "hierarchical" if zc and zc < z else "legacy"

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

    def run_arrays(self, u, v, t, valid, signs, *,
                   label: str = "") -> CodeCounts:
        """Mine raw [Z, E] zone arrays (+ [Z] signs) to signed code counts."""
        u, v, t, valid, signs = (np.asarray(x)
                                 for x in (u, v, t, valid, signs))
        z, e = u.shape
        ck = self.execution_key(z, e) if self.obs.enabled else None
        with self.obs.tracer.span("mine.launch", z=z, e=e, label=label,
                                  compile_key=ck) as sp:
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
                u, v, t, valid, signs = pad_zone_arrays(
                    u, v, t, valid, signs, n_rows=z + (zc - z % zc))
                z = u.shape[0]
            mode = self._agg_mode_for(zc, z)
            if mode != "legacy":
                raise NotImplementedError(
                    f"agg mode {mode!r} (the bounded per-chunk fold) is "
                    f"{_SLICE2}; use agg='legacy'")
            sp.set(agg=mode, zone_chunk=zc)
            dev = self.device
            tensors = [torch.as_tensor(x, device=dev)
                       for x in (u, v, t, valid, signs)]
            codes, lengths = _chunked_scan(
                self.spec.scan, *tensors[:4], delta=self.delta,
                l_max=self.l_max, zone_chunk=zc)
            counts = aggregation.aggregate_zones(codes, lengths, tensors[4])
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

    def _fused_path(self) -> str:
        """Stats ``path`` label: "fused" when the executor's own backend
        ran the scan, "fused_<name>" when dispatch rerouted it."""
        fspec = self._fused_spec()
        return "fused" if fspec.name == self.backend else \
            f"fused_{fspec.name}"

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
        """Mine a :class:`ZoneBatchLayout` exactly.

        Dispatch is decided by :meth:`resolve_fused`; the fused path
        (:meth:`run_fused`) is the one this slice ports.
        """
        if self.resolve_fused(fused):
            return self.run_fused(layout, allow_overflow=allow_overflow)
        raise NotImplementedError(
            f"the per-bucket layout path (backend {self.backend!r} without "
            f"a fused scan, or fused='off') is {_SLICE2}; use a backend "
            f"with a fused scan (cuda, torch) or fused_backend='torch'")

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
        fl = concat_layout(layout, blk=blk, pad_slots_to=fold_chunk,
                           delta=self.delta, l_max=self.l_max,
                           bounds=self.fused_bounds)
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
        with obs.tracer.span("mine.h2d", n_slots=fl.n_slots) as sp:
            u, v, t, valid, zone_id, sign, lo, hi = (
                torch.as_tensor(x, device=self.device) for x in (
                    fl.u, fl.v, fl.t, fl.valid, fl.zone_id, fl.sign, fl.lo,
                    fl.hi))
            sp.sync(u)
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
            need = max(2 * merge_cap, merge_cap + n_spilled, 8)
            new_cap = min(1 << (need - 1).bit_length(), cap_ceiling)
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
