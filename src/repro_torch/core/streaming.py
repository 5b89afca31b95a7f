"""Incremental streaming discovery on top of the unified executor.

Real temporal-graph workloads arrive as unbounded, time-ordered streams.
TZP's signed growth/boundary decomposition (Lemma 4.2) is naturally
incremental: counts are a signed sum over zones, and the identity holds for
*any* partition whose consecutive zones overlap by exactly ``L_b = delta *
l_max`` and are each at least ``2 * L_b`` long.  A growth/boundary zone pair
``(G_i = [s_i, e_i), B_i = [e_i - L_b, e_i))`` is **final** once the stream
head has moved past ``e_i + L_b``: no future edge can extend any process
seeded before ``e_i`` (the per-step gap bound is ``delta <= L_b``), so the
pair can be mined immediately and merged into the running totals, and every
edge older than ``s_{i+1} = e_i - L_b`` can be discarded.

:class:`StreamingMiner` therefore keeps only a sliding buffer of
not-yet-finalized edges.  ``snapshot()`` mines the still-open tail of the
**closed prefix** (edges with ``t < t_head - L_b``) as a fresh mini zone
plan and merges it with the finalized totals — by Lemma 4.2 the result
equals batch ``discover()`` run on that prefix, exactly, per code (tested in
the JAX package's ``tests/test_streaming.py`` and the port's
``tests/test_torch_streaming.py``), whenever batch discovery itself is exact
(``overflow == 0``).  The streaming miner never drops edges: with a small
``e_cap`` on bursty data, batch ``discover`` may overflow zone capacity and
undercount, while snapshots stay oracle-exact — cross-checks against a
batch run must first confirm its ``overflow`` is zero.  Finalized-pair
contributions never change as
more data arrives; like batch discovery on a truncated stream, processes
seeded within ``L_b`` of the prefix end are reported as currently observed
and may still grow in later snapshots.

All mining goes through :class:`repro_torch.core.executor.MiningExecutor`
— the streaming layer owns frontier bookkeeping only.  On the ``cuda``
backend a finalized pair and a tail mine each launch the flat zone-scan
kernel once (``fused="auto"``), or the dense kernel once per bucket
(``fused="off"``).  The miner runs on CUDA unless ``device`` says
otherwise; with no CUDA device and no explicit device it raises.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.obs import get_obs
from repro_torch.obs.timing import Stopwatch

from . import transitions, tzp
from .api import DiscoveryResult
from .config import MiningConfig
from .executor import MiningExecutor
from .temporal_graph import TemporalGraph


def validate_edge_chunk(u, v, t) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Validate and coerce one edge chunk to ``(int32 u, int32 v, int64 t)``.

    ``np.asarray(x, np.int32)`` silently wraps out-of-range node ids and
    truncates float timestamps — a tenant sending ids >= 2**31 would get
    corrupted motif counts with no error.  This is the single ingestion
    guard (:class:`StreamingMiner` and the serving ``MotifSession`` both
    route through it): non-integer dtypes and values outside the target
    dtype's range raise ``ValueError`` before anything is buffered.
    """
    out = []
    for name, x, dtype in (("u", u, np.int32), ("v", v, np.int32),
                           ("t", t, np.int64)):
        arr = np.asarray(x)
        if arr.dtype.kind not in "iu":
            raise ValueError(
                f"edge chunk field {name!r} must be integer-typed, got "
                f"dtype {arr.dtype} (floats would be silently truncated)")
        info = np.iinfo(dtype)
        if arr.size and (int(arr.min()) < info.min
                         or int(arr.max()) > info.max):
            raise ValueError(
                f"edge chunk field {name!r} has values outside "
                f"{np.dtype(dtype).name} range [{info.min}, {info.max}]; "
                f"they would silently wrap and corrupt motif counts")
        out.append(arr.astype(dtype, copy=False).ravel())
    u, v, t = out
    if not (u.shape == v.shape == t.shape):
        raise ValueError("u, v, t must have identical shapes")
    return u, v, t


def _merge_into(total: dict[str, int], part: dict[str, int]) -> None:
    for code, cnt in part.items():
        new = total.get(code, 0) + cnt
        if new:
            total[code] = new
        else:
            total.pop(code, None)


def replay_stream(miner: "StreamingMiner", graph, chunk_edges: int):
    """Feed ``graph`` through ``miner`` in chunks; measure ingest latency.

    Shared by the CLI ``--stream`` mode and ``benchmarks/bench_streaming``
    so both report the same metric.  Returns ``(latencies, total_seconds)``
    with one latency per ingested chunk.
    """
    if chunk_edges < 1:
        raise ValueError("chunk_edges must be >= 1")
    latencies = []
    with Stopwatch() as total:
        for i in range(0, graph.n_edges, chunk_edges):
            with Stopwatch() as sw:
                miner.ingest(graph.u[i:i + chunk_edges],
                             graph.v[i:i + chunk_edges],
                             graph.t[i:i + chunk_edges])
            latencies.append(sw.seconds)
    return latencies, total.seconds


@dataclasses.dataclass(frozen=True)
class SnapshotView:
    """Immutable capture of everything a non-final ``snapshot()`` reads.

    Produced by :meth:`StreamingMiner.freeze` under the caller's ingest
    synchronization; mined by :meth:`StreamingMiner.mine_view` **without**
    that synchronization (the serving layer's first-query-of-an-epoch mine
    no longer stalls concurrent ingest).  The buffer arrays are captured by
    reference — ``ingest`` replaces them wholesale and never writes in
    place, so a view stays internally consistent while new edges arrive;
    the finalized-counts dict *is* mutated in place by finalization and is
    therefore copied at freeze time.
    """

    epoch: int
    sig: tuple                    # tail-layout signature at freeze time
    counts: dict                  # finalized-pair counts (copy)
    n_zones_finalized: int
    u: np.ndarray
    v: np.ndarray
    t: np.ndarray
    cut: int                      # buffered edges inside the closed prefix
    cached_tail: tuple | None     # (tail_counts, tail_zones, tail_cap)


class StreamingMiner:
    """Ingests time-ordered edge chunks; maintains running exact counts.

    Parameters come in as one validated
    :class:`~repro_torch.core.config.MiningConfig` (``config=``), or as the
    legacy individual kwargs (``delta=, l_max=, ...`` — a config is built
    internally), but never both.  ``executor=`` optionally shares an
    already-built :class:`MiningExecutor` (the
    :class:`repro_torch.core.engine.PTMTEngine` path — one executor on one
    device across batch and stream modes); it must agree with the config.
    ``device=`` places an executor built here (CUDA unless given; with no
    CUDA device and no ``device`` construction raises); a shared executor
    brings its own device and ``device`` must then be left out.

    Usage::

        miner = StreamingMiner(delta=600, l_max=6, backend="cuda")
        for u, v, t in chunks:           # t non-decreasing across chunks
            miner.ingest(u, v, t)
        result = miner.snapshot()        # exact counts on the closed prefix
        final = miner.snapshot(final=True)   # treat the stream as ended
    """

    def __init__(
        self,
        *,
        config: MiningConfig | None = None,
        executor: MiningExecutor | None = None,
        delta: int | None = None,
        l_max: int | None = None,
        omega: int | None = None,
        e_cap: int | None = None,
        backend: str | None = None,
        zone_chunk: int | None = None,
        agg: str | None = None,
        merge_cap: int | None = None,
        memory_budget_mb: float | None = None,
        device=None,
        obs=None,
    ):
        legacy = {k: v for k, v in dict(
            delta=delta, l_max=l_max, omega=omega, e_cap=e_cap,
            backend=backend, zone_chunk=zone_chunk, agg=agg,
            merge_cap=merge_cap, memory_budget_mb=memory_budget_mb,
        ).items() if v is not None}
        if config is None:
            # delta/l_max have no safe fallback here: silently mining with
            # the config defaults would return plausible-but-wrong counts
            if delta is None or l_max is None:
                raise ValueError(
                    "delta and l_max are required (or pass config=)")
            config = MiningConfig(**legacy)     # validates
        elif legacy:
            raise ValueError(
                f"pass either a MiningConfig or individual parameters, "
                f"not both (got config plus {sorted(legacy)})")
        if executor is not None:
            if device is not None:
                raise ValueError(
                    "a shared executor brings its own device; pass either "
                    "executor= or device=, not both")
            # self.config is exposed as the source of truth for execution
            # parameters (the serving layer reports it), so a shared
            # executor must match on every field from_config would set
            ref = MiningExecutor.from_config(config, device=executor.device)
            mismatch = [
                f for f in ("delta", "l_max", "backend", "zone_chunk",
                            "agg", "merge_cap", "memory_budget_mb")
                if getattr(executor, f) != getattr(ref, f)
            ]
            if mismatch:
                raise ValueError(
                    f"executor disagrees with config on {mismatch} — "
                    f"mining would not run with the parameters "
                    f"self.config reports")
        self.config = config
        self.delta = config.delta
        self.l_max = config.l_max
        self.omega = config.omega
        self.e_cap = config.e_cap
        self.l_b = config.l_b
        self.l_g = self.omega * self.l_b
        # obs resolution: an explicit bundle wins, else inherit the shared
        # executor's (the engine.stream() path — one bundle across batch
        # and stream modes), else the no-op default
        self.obs = get_obs(obs) if obs is not None else (
            executor.obs if executor is not None else get_obs(None))
        self.executor = executor if executor is not None \
            else MiningExecutor.from_config(config, device=device,
                                            obs=self.obs)

        self._u = np.zeros(0, np.int32)     # sliding buffer: edges >= s
        self._v = np.zeros(0, np.int32)
        self._t = np.zeros(0, np.int64)
        self._s: int | None = None          # next zone start time
        self._t_head: int | None = None     # newest ingested timestamp
        self._counts: dict[str, int] = {}   # merged finalized-pair counts
        self.n_edges_ingested = 0
        self.n_edges_retired = 0            # dropped from the buffer
        self.n_zones_finalized = 0
        self._epoch = 0
        self._closed_sig: tuple = (None, 0)
        # cache of the open-tail mining result, keyed by (epoch, layout
        # signature): (epoch, sig, tail_counts, tail_zones, tail_cap).
        # snapshot() is a pure function of the closed prefix and the
        # epoch bumps exactly when that prefix changes, so reuse is exact
        # — the finalized partial counts in self._counts are never
        # re-mined, and between finalizations the tail is not either.
        # The signature covers every setting that shapes the tail's zone
        # layout (layout kind, e_cap, chunking), so a bucket-affecting
        # change invalidates the cached mine instead of serving a result
        # computed under a different layout.
        self._tail_cache: tuple | None = None
        self.tail_cache_hits = 0
        self.tail_cache_misses = 0
        self.last_tail_layout: dict | None = None
        # metric-label tag for multi-miner processes (the serving layer
        # sets this to the tenant name); empty means unlabeled series
        self.obs_label = ""

    def _obs_labels(self) -> dict:
        return {"miner": self.obs_label} if self.obs_label else {}

    # -- stream state -------------------------------------------------------

    @property
    def t_head(self) -> int | None:
        return self._t_head

    @property
    def closed_time(self) -> int | None:
        """Exclusive upper bound of the closed (final) prefix."""
        if self._t_head is None:
            return None
        return int(self._t_head) - self.l_b

    @property
    def buffered_edges(self) -> int:
        return int(self._t.shape[0])

    @property
    def epoch(self) -> int:
        """Monotone counter that bumps exactly when the closed prefix changes.

        ``snapshot()`` (non-final) is a pure function of the closed prefix:
        the merged finalized-pair counts plus the buffered edges with ``t <
        closed_time``.  Both can only change when ``closed_time`` advances or
        a pair finalizes — newly ingested edges always satisfy ``t >=
        t_head_old > closed_time_old`` and so never land inside an unchanged
        closed prefix.  Equal epochs therefore guarantee equal snapshots,
        which makes epoch-keyed snapshot caches (the serving layer) exact:
        invalidation happens precisely when the answer could differ, never on
        a clock.
        """
        return self._epoch

    # -- ingestion ----------------------------------------------------------

    def ingest(self, u, v, t) -> None:
        """Append one time-ordered edge chunk and advance the frontier.

        Raises ``ValueError`` on non-integer or out-of-range input (see
        :func:`validate_edge_chunk`) — nothing is buffered on rejection.
        """
        u, v, t = validate_edge_chunk(u, v, t)
        if t.size == 0:
            return
        if np.any(np.diff(t) < 0):
            raise ValueError("chunk timestamps must be non-decreasing")
        if self._t_head is not None and int(t[0]) < self._t_head:
            raise ValueError(
                f"chunk starts at t={int(t[0])} before the stream head "
                f"{self._t_head}; edges must arrive time-ordered"
            )
        with self.obs.tracer.span("stream.ingest", edges=int(t.size)):
            self._u = np.concatenate([self._u, u])
            self._v = np.concatenate([self._v, v])
            self._t = np.concatenate([self._t, t])
            self._t_head = int(t[-1])
            if self._s is None:
                self._s = int(self._t[0])
            self.n_edges_ingested += int(t.size)
            self._advance()
            sig = (self.closed_time, self.n_zones_finalized)
            if sig != self._closed_sig:
                self._closed_sig = sig
                self._epoch += 1
        if self.obs.enabled:
            labels = self._obs_labels()
            m = self.obs.metrics
            m.gauge("repro_streaming_epoch", **labels).set(self._epoch)
            m.gauge("repro_streaming_buffered_edges",
                    **labels).set(self.buffered_edges)

    def _advance(self) -> None:
        """Finalize every growth/boundary pair fully behind the frontier."""
        while True:
            if self._t.size == 0:
                return
            limit = self._t_head - self.l_b
            # quiet-gap skip: no edges exist in [s, t0), so jumping the zone
            # start to the next buffered edge leaves the signed cover exact
            # (empty zones contribute nothing) and keeps ingest O(zones with
            # edges) instead of one iteration per empty l_g-window.
            t0 = int(self._t[0])
            if t0 > self._s:
                self._s = t0
            s = self._s
            e = s + self.l_g
            if e > limit:
                return
            # adaptive shrink, same rule as the batch planner (all edges in
            # [s, e) have arrived because e <= limit < t_head)
            lo = int(np.searchsorted(self._t, s, side="left"))
            e = tzp.adaptive_zone_end(self._t, s, e, e_cap=self.e_cap,
                                      l_b=self.l_b)
            self._finalize_pair(s, e, lo)
            new_s = e - self.l_b
            keep = int(np.searchsorted(self._t, new_s, side="left"))
            self.n_edges_retired += keep
            self._u = self._u[keep:]
            self._v = self._v[keep:]
            self._t = self._t[keep:]
            self._s = new_s

    def _finalize_pair(self, s: int, e: int, lo: int) -> None:
        """Mine G = [s, e) with sign +1 and B = [e - l_b, e) with sign -1.

        The pair goes through the same :func:`tzp.build_zone_layout` →
        :meth:`MiningExecutor.run_layout` pipeline as batch discovery — a
        two-zone plan over the pair's edge slice — but always as the
        **dense** layout: a 2-row batch has almost nothing to bucket,
        while splitting G and B into separate capacity buckets would
        double the per-pair launches on the per-bucket path and add a
        cross-bucket merge on the ingest hot path.  The layout kind and
        ``e_cap`` are also what the JAX package reports for the pair
        (``DiscoveryResult.n_zones``/``e_cap``), so both packages give
        the same results.  The multi-zone tail mine is where the
        configured layout pays off.
        """
        hi = int(np.searchsorted(self._t, e, side="left"))
        b_lo = int(np.searchsorted(self._t, e - self.l_b, side="left"))
        g_cnt = hi - lo
        b_cnt = hi - b_lo
        if g_cnt == 0:
            self.n_zones_finalized += 2
            return
        # rebase timestamps to the pair start so the kernels' int32 times
        # never overflow (counts are shift-invariant, only gaps matter)
        t_base = int(self._t[lo])
        pair = TemporalGraph(
            u=self._u[lo:hi], v=self._v[lo:hi],
            t=(self._t[lo:hi] - t_base).astype(np.int32),
            n_nodes=int(max(self._u[lo:hi].max(initial=-1),
                            self._v[lo:hi].max(initial=-1)) + 1),
        )
        plan = tzp.ZonePlan(
            lo=np.asarray([0, b_lo - lo], np.int64),
            count=np.asarray([g_cnt, b_cnt], np.int64),
            sign=np.asarray([1, -1], np.int32),
            t_start=np.asarray([s - t_base, e - self.l_b - t_base],
                               np.int64),
            t_end=np.asarray([e - t_base, e - t_base], np.int64),
            l_b=self.l_b,
        )
        # a power-of-two cap, as the JAX package sets it (it fixes the
        # pair's padded zone width, hence e_cap in the results)
        with self.obs.tracer.span("stream.finalize", edges=g_cnt):
            layout = tzp.build_zone_layout(
                pair, plan, layout="dense",
                e_cap=tzp.next_pow2(max(g_cnt, 8)),
            )
            counts = self.executor.run_layout(layout).counts
            _merge_into(self._counts,
                        transitions.device_counts_to_dict(counts))
        self.n_zones_finalized += 2

    # -- results ------------------------------------------------------------

    def snapshot(self, *, final: bool = False) -> DiscoveryResult:
        """Exact counts over the closed prefix (``t < t_head - L_b``).

        With ``final=True`` the stream is treated as ended and every
        buffered edge is mined (the result then equals batch ``discover``
        over everything ingested).  ``snapshot`` never mutates miner state
        (only the epoch-keyed tail cache); it can be called at any time,
        repeatedly — repeated calls within one epoch reuse both the
        finalized partial counts and the cached open-tail mine, so only the
        first snapshot of an epoch pays for device work.
        """
        if final:
            counts = dict(self._counts)
            tail_counts, tail_zones, tail_cap = self._mine_tail_arrays(
                self._u, self._v, self._t, int(self._t.size), final=True)
            _merge_into(counts, tail_counts)
            return DiscoveryResult(
                counts=counts, n_zones=self.n_zones_finalized + tail_zones,
                e_cap=tail_cap, overflow=0, delta=self.delta,
                l_max=self.l_max,
            )
        view = self.freeze()
        result, tail = self.mine_view(view)
        self.adopt_tail(view, tail)
        return result

    # -- lock-free snapshot protocol ----------------------------------------

    def freeze(self) -> SnapshotView:
        """Capture a :class:`SnapshotView` of the current closed prefix.

        Call under the same synchronization as ``ingest`` (the serving
        session holds its lock).  The capture is O(#finalized codes): array
        references plus one dict copy — no mining happens here.
        """
        if self._t.size == 0:
            cut = 0
        else:
            cut = int(np.searchsorted(self._t, self.closed_time,
                                      side="left"))
        sig = self._tail_sig()
        cached = None
        if self._tail_cache is not None \
                and self._tail_cache[:2] == (self._epoch, sig):
            cached = self._tail_cache[2:]
        return SnapshotView(
            epoch=self._epoch, sig=sig, counts=dict(self._counts),
            n_zones_finalized=self.n_zones_finalized,
            u=self._u, v=self._v, t=self._t, cut=cut, cached_tail=cached,
        )

    def mine_view(self, view: SnapshotView):
        """Mine a frozen view into ``(DiscoveryResult, tail_tuple)``.

        Safe to call *outside* the ingest synchronization: it reads only
        the view (immutable by construction) and the executor, whose
        concurrent runs are supported (per-run stats travel in the
        ``RunOutcome``).  Pass the tail tuple back through
        :meth:`adopt_tail` (under the lock again) to publish the mine into
        the epoch-keyed tail cache.
        """
        if view.cached_tail is not None:
            tail = view.cached_tail
        else:
            tail = self._mine_tail_arrays(view.u, view.v, view.t, view.cut,
                                          final=False)
        counts = dict(view.counts)
        _merge_into(counts, tail[0])
        result = DiscoveryResult(
            counts=counts, n_zones=view.n_zones_finalized + tail[1],
            e_cap=tail[2], overflow=0, delta=self.delta, l_max=self.l_max,
        )
        return result, tail

    def adopt_tail(self, view: SnapshotView, tail: tuple) -> None:
        """Publish a mined view's tail into the cache (CAS semantics).

        Call under the same synchronization as ``ingest``.  A stale
        publish — the epoch moved on while the mine ran — is discarded:
        the cache only ever holds a tail computed for the *current* epoch,
        so exactness is preserved no matter how the mine raced ingest.
        """
        if view.cached_tail is not None:
            self.tail_cache_hits += 1
            self.obs.metrics.counter("repro_streaming_tail_cache_hits_total",
                                     **self._obs_labels()).inc()
            return
        self.tail_cache_misses += 1
        self.obs.metrics.counter("repro_streaming_tail_cache_misses_total",
                                 **self._obs_labels()).inc()
        if self._epoch == view.epoch:
            self._tail_cache = (view.epoch, view.sig) + tuple(tail)

    def _tail_sig(self) -> tuple:
        """Settings that shape the tail's zone layout (cache invalidation).

        Defensive: every component is fixed at construction today (the
        config is frozen), so within one miner the signature only restates
        the epoch key.  It exists to pin the contract — the cached tail
        mine is only valid for the layout settings it was computed under —
        so a future mutable setting (or a subclass) cannot silently serve
        a mine computed under a different bucket decomposition.
        """
        return (self.config.zone_layout, self.e_cap,
                self.executor.zone_chunk)

    def _mine_tail_arrays(self, u: np.ndarray, v: np.ndarray,
                          t: np.ndarray, cut: int,
                          final: bool) -> tuple[dict[str, int], int, int]:
        """Mine the first ``cut`` buffered edges of ``(u, v, t)``; returns
        ``(counts, n_zones, e_cap)``.

        The tail flows through the same plan → :func:`tzp.
        build_zone_layout` → :meth:`MiningExecutor.run_layout` pipeline as
        batch discovery, so streaming inherits the size-bucketed layout
        (``self.last_tail_layout`` records the decomposition used).  The
        arrays come in explicitly (not read off ``self``) so a frozen
        :class:`SnapshotView` can be mined concurrently with ingest.
        """
        if t.size == 0 or cut == 0:
            return {}, 0, 0
        with self.obs.tracer.span("stream.tail_mine", edges=cut,
                                  final=final) as sp:
            # rebase to the tail start: int32-safe, shift-invariant
            tail = TemporalGraph(
                u=u[:cut], v=v[:cut],
                t=(t[:cut] - t[0]).astype(np.int32),
                n_nodes=int(max(u[:cut].max(initial=-1),
                                v[:cut].max(initial=-1)) + 1),
            )
            plan = tzp.plan_zones(
                tail, delta=self.delta, l_max=self.l_max,
                omega=self.omega, e_cap=self.e_cap,
            )
            layout = tzp.build_zone_layout(
                tail, plan, layout=self.config.zone_layout,
                pad_zones_to=self.executor.zone_chunk or 1,
                # as the JAX package pads the tail: it fixes the tail's
                # e_cap, which the snapshot reports
                pad_edges_to=64,
            )
            sp.set(n_zones=plan.n_zones)
            tail_counts = self.executor.run_layout(layout).counts
            self.last_tail_layout = layout.summary()
        return (transitions.device_counts_to_dict(tail_counts),
                plan.n_zones, layout.e_cap)

    # -- checkpoint state round-trip -----------------------------------------

    def state_dict(self) -> dict:
        """Exact capture of the miner's durable state (checkpointing).

        Call under the same synchronization as ``ingest``.  The dict holds
        the frozen config, the finalized closed-prefix counts, the epoch
        and its closure signature, the frontier cursors, the monotone
        counters, the open-tail edge buffer (copies — a checkpoint must
        not alias the live buffer), and the tail-layout signature.  A
        miner restored from it and fed the remainder of the stream is
        **byte-identical** to one that never stopped: every field that
        influences future finalization or snapshots is included, and the
        epoch-keyed tail cache — a pure re-derivable function of the rest
        — is deliberately excluded (the first snapshot after restore
        replays only the open tail).
        """
        return {
            "config": self.config.to_dict(),
            "epoch": self._epoch,
            "closed_sig": list(self._closed_sig),
            "counts": dict(self._counts),
            "zone_start": self._s,
            "t_head": self._t_head,
            "n_edges_ingested": self.n_edges_ingested,
            "n_edges_retired": self.n_edges_retired,
            "n_zones_finalized": self.n_zones_finalized,
            "tail_u": self._u.copy(),
            "tail_v": self._v.copy(),
            "tail_t": self._t.copy(),
            "tail_sig": list(self._tail_sig()),
        }

    def restore_state(self, state: dict) -> None:
        """Install a :meth:`state_dict` capture into this (fresh) miner.

        The miner must have been constructed with the *same* config the
        state was captured under, and its executor must resolve the same
        tail-layout signature — a restored session that would silently
        mine under different layout settings is rejected instead, because
        the byte-identity guarantee only holds when the restored pipeline
        is the checkpointed one.
        """
        cfg = state["config"]
        if cfg != self.config.to_dict():
            theirs = MiningConfig.from_json(cfg)
            raise ValueError(
                f"checkpointed config {theirs.to_json()} does not match "
                f"this miner's {self.config.to_json()}; restore into a "
                f"miner built from the checkpointed config")
        sig = list(self._tail_sig())
        if list(state.get("tail_sig", sig)) != sig:
            raise ValueError(
                f"checkpointed tail-layout signature {state['tail_sig']} "
                f"does not match this miner's {sig}; the executor's "
                f"layout settings differ from the checkpointed ones")
        u, v, t = validate_edge_chunk(
            state["tail_u"], state["tail_v"], state["tail_t"])
        self._u, self._v, self._t = u, v, t
        self._s = None if state["zone_start"] is None \
            else int(state["zone_start"])
        self._t_head = None if state["t_head"] is None \
            else int(state["t_head"])
        self._counts = {str(c): int(n) for c, n in state["counts"].items()}
        self.n_edges_ingested = int(state["n_edges_ingested"])
        self.n_edges_retired = int(state["n_edges_retired"])
        self.n_zones_finalized = int(state["n_zones_finalized"])
        self._epoch = int(state["epoch"])
        self._closed_sig = tuple(state["closed_sig"])
        # re-derivable: the first snapshot after restore re-mines the tail
        self._tail_cache = None
