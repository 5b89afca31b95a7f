"""Temporal Zone Partitioning (TZP) — Algorithm 1, with adaptive zoning.

Growth zone ``G_i = [s_i, e_i)`` with ``e_i - s_i >= 2 * L_b`` where
``L_b = delta * l_max`` (the maximum time span of one motif transition
process, including its trailing time-out window).  Consecutive growth zones
overlap by exactly ``L_b``; the overlap is the boundary zone
``B_i = [s_{i+1}, e_i)``.  Counting every zone independently and summing with
sign +1 (growth) / -1 (boundary) reproduces exact global counts
(inclusion-exclusion, Lemma 4.2).

Beyond-paper: the paper fixes ``omega`` globally; we additionally shrink a
growth zone whose edge population exceeds ``e_cap`` (down to the correctness
floor ``2 * L_b``), which bounds the padded zone batch and load imbalance on
bursty streams.  Zones are host-side metadata (data-pipeline work); the
device-side batch is built once per mining run.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json

import numpy as np

from .temporal_graph import TemporalGraph


@dataclasses.dataclass(frozen=True)
class ZonePlan:
    """Host-side partition table (one row per zone, time-ordered)."""

    lo: np.ndarray        # int64[Z] first edge index of the zone
    count: np.ndarray     # int64[Z] number of edges in the zone
    sign: np.ndarray      # int32[Z] +1 growth / -1 boundary
    t_start: np.ndarray   # int64[Z] zone window start (inclusive)
    t_end: np.ndarray     # int64[Z] zone window end (exclusive)
    l_b: int              # boundary length delta * l_max

    @property
    def n_zones(self) -> int:
        return int(self.lo.shape[0])

    @property
    def n_growth(self) -> int:
        return int((self.sign > 0).sum())

    @property
    def max_count(self) -> int:
        return int(self.count.max()) if self.n_zones else 0

    # -- serialization (the engine-level zone-plan cache persists plans) ----

    def to_json(self) -> str:
        """Exact JSON round-trip (``from_json(to_json(p)) == p``)."""
        return json.dumps({
            "lo": self.lo.tolist(),
            "count": self.count.tolist(),
            "sign": self.sign.tolist(),
            "t_start": self.t_start.tolist(),
            "t_end": self.t_end.tolist(),
            "l_b": self.l_b,
        }, sort_keys=True)

    @classmethod
    def from_json(cls, data: str | bytes | dict) -> "ZonePlan":
        """Inverse of :meth:`to_json`; also accepts an already-parsed dict."""
        if not isinstance(data, dict):
            data = json.loads(data)
        known = {"lo", "count", "sign", "t_start", "t_end", "l_b"}
        unknown = sorted(set(data) - known)
        if unknown:
            raise ValueError(
                f"unknown ZonePlan field(s) {unknown}; known: {sorted(known)}")
        return cls(
            lo=np.asarray(data["lo"], np.int64),
            count=np.asarray(data["count"], np.int64),
            sign=np.asarray(data["sign"], np.int32),
            t_start=np.asarray(data["t_start"], np.int64),
            t_end=np.asarray(data["t_end"], np.int64),
            l_b=int(data["l_b"]),
        )

    def __eq__(self, other) -> bool:
        if not isinstance(other, ZonePlan):
            return NotImplemented
        return self.l_b == other.l_b and all(
            np.array_equal(getattr(self, f), getattr(other, f))
            for f in ("lo", "count", "sign", "t_start", "t_end"))


def graph_fingerprint(graph: TemporalGraph) -> str:
    """Cheap content hash of a temporal graph (zone-plan cache key part).

    Hashes the raw edge arrays, so two graphs with identical streams share
    a fingerprint regardless of object identity.  O(n) but vastly cheaper
    than re-running Algorithm 1's zone scan; the engine memoizes plans
    under ``(fingerprint, delta, l_max, omega, e_cap)``.
    """
    h = hashlib.blake2b(digest_size=16)
    h.update(np.int64(graph.n_edges).tobytes())
    for arr in (graph.u, graph.v, graph.t):
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def adaptive_zone_end(t: np.ndarray, s: int, e: int, *, e_cap: int | None,
                      l_b: int) -> int:
    """Adaptive shrink of a growth zone's end (beyond-paper, see module doc).

    If more than ``e_cap`` edges fall in ``[s, e)``, shrink ``e`` to the
    time of the ``(e_cap+1)``-th edge, floored at the correctness minimum
    ``s + 2*l_b``.  Shared by the batch planner and the streaming frontier
    so the zone geometry rule lives in exactly one place.
    """
    if e_cap is None:
        return e
    lo = int(np.searchsorted(t, s, side="left"))
    hi_target = int(np.searchsorted(t, e, side="left"))
    if hi_target - lo <= e_cap:
        return e
    e_shrunk = int(t[lo + e_cap])
    return int(np.clip(e_shrunk, s + 2 * l_b, e))


def pad_zone_arrays(u, v, t, valid, signs, *, n_rows: int):
    """Append inert zone rows so the batch has exactly ``n_rows`` zones.

    The one copy of the "inert row" definition: all-invalid edges and sign
    0, so a padded row seeds no candidates and its signed contribution is
    identically zero.  Used by the executor's ``pad_policy="pad"`` path
    (zone counts that do not divide ``zone_chunk``) — the same rule
    :func:`build_zone_batch` applies via ``pad_zones_to``, shared instead
    of re-derived inline at the call site.
    """
    z = u.shape[0]
    if n_rows < z:
        raise ValueError(
            f"cannot pad a {z}-zone batch down to {n_rows} rows")
    if n_rows == z:
        return u, v, t, valid, signs
    pad = n_rows - z
    pad_rows = lambda x: np.concatenate(
        [x, np.zeros((pad, *x.shape[1:]), x.dtype)])
    u, v, t, valid = map(pad_rows, (u, v, t, valid))
    signs = np.concatenate([signs, np.zeros(pad, signs.dtype)])
    return u, v, t, valid, signs


def fill_zone_row(u_row, v_row, t_row, valid_row, su, sv, st) -> None:
    """Copy one zone's edges into a padded batch row (in place).

    Padding timestamps repeat the zone max so kernel-level block skipping
    stays conservative (padding edges are masked out by ``valid``).
    """
    cnt = len(su)
    u_row[:cnt] = su
    v_row[:cnt] = sv
    t_row[:cnt] = st
    if cnt:
        t_row[cnt:] = st[-1]
    valid_row[:cnt] = True


def plan_zones(
    graph: TemporalGraph,
    *,
    delta: int,
    l_max: int,
    omega: int = 20,
    e_cap: int | None = None,
) -> ZonePlan:
    """Algorithm 1: linear scan creating interleaved growth/boundary zones."""
    if delta < 1 or l_max < 1:
        raise ValueError("delta and l_max must be >= 1")
    if omega < 2:
        raise ValueError("omega must be >= 2 (growth zone >= 2 boundary zones)")
    t = graph.t.astype(np.int64)
    n = t.shape[0]
    l_b = delta * l_max
    l_g = omega * l_b

    lo_list, cnt_list, sign_list, ts_list, te_list = [], [], [], [], []
    if n == 0:
        return ZonePlan(*[np.zeros(0, np.int64) for _ in range(2)],
                        np.zeros(0, np.int32), np.zeros(0, np.int64),
                        np.zeros(0, np.int64), l_b)

    t_max = int(t[-1])
    s = int(t[0])
    while True:
        e = s + l_g
        lo = int(np.searchsorted(t, s, side="left"))
        if e <= t_max:
            e = adaptive_zone_end(t, s, e, e_cap=e_cap, l_b=l_b)
        hi = int(np.searchsorted(t, e, side="left"))
        lo_list.append(lo)
        cnt_list.append(hi - lo)
        sign_list.append(1)
        ts_list.append(s)
        te_list.append(e)
        if e > t_max:
            break
        # boundary zone = overlap [e - l_b, e)
        b_lo = int(np.searchsorted(t, e - l_b, side="left"))
        lo_list.append(b_lo)
        cnt_list.append(hi - b_lo)
        sign_list.append(-1)
        ts_list.append(e - l_b)
        te_list.append(e)
        s = e - l_b

    return ZonePlan(
        lo=np.asarray(lo_list, np.int64),
        count=np.asarray(cnt_list, np.int64),
        sign=np.asarray(sign_list, np.int32),
        t_start=np.asarray(ts_list, np.int64),
        t_end=np.asarray(te_list, np.int64),
        l_b=l_b,
    )


def single_zone_plan(graph: TemporalGraph, *, l_b: int) -> ZonePlan:
    """One growth zone spanning the whole stream (the TMC-analog baseline).

    The degenerate partition: no boundary zones, sign +1, every edge in one
    row.  Routing the sequential baseline through this plan +
    :func:`build_zone_batch` keeps the padding/fill policy in exactly one
    place instead of a hand-rolled zero-pad block at the call site.
    """
    t = graph.t.astype(np.int64)
    n = int(t.shape[0])
    t0 = int(t[0]) if n else 0
    t_end = int(t[-1]) + 1 if n else 1
    return ZonePlan(
        lo=np.zeros(1, np.int64),
        count=np.asarray([n], np.int64),
        sign=np.ones(1, np.int32),
        t_start=np.asarray([t0], np.int64),
        t_end=np.asarray([t_end], np.int64),
        l_b=l_b,
    )


@dataclasses.dataclass(frozen=True)
class ZoneBatch:
    """Device-ready padded zone batch.

    Arrays are [Z, e_cap]; ``valid`` masks real edges.  ``perm`` records the
    size-balanced zone order (descending population round-robin across
    ``n_shards`` — static load balancing replacing the paper's work stealing).
    """

    u: np.ndarray
    v: np.ndarray
    t: np.ndarray
    valid: np.ndarray
    sign: np.ndarray      # int32[Z]
    perm: np.ndarray      # int64[Z] original zone index per row
    overflow: int         # edges dropped because a zone exceeded e_cap
    label: str = ""       # bucket name in a ZoneBatchLayout ("" = dense)

    @property
    def n_zones(self) -> int:
        return int(self.u.shape[0])

    @property
    def e_cap(self) -> int:
        return int(self.u.shape[1])

    @property
    def n_real_zones(self) -> int:
        """Rows carrying a planned zone (``perm >= 0``; the rest are pad)."""
        return int((self.perm >= 0).sum())

    @property
    def valid_edges(self) -> int:
        return int(self.valid.sum())

    @property
    def padded_slots(self) -> int:
        """Total device edge slots, real or padding (``Z * e_cap``)."""
        return self.n_zones * self.e_cap

    @property
    def occupancy(self) -> float:
        """Fraction of edge slots holding real edges (1 - padding waste)."""
        return self.valid_edges / max(self.padded_slots, 1)


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def dense_cap(plan: ZonePlan, *, e_cap: int | None = None,
              pad_edges_to: int = 8) -> int:
    """The dense layout's per-zone edge capacity for ``plan``.

    The single copy of the rule — :func:`build_zone_batch`,
    :func:`resolve_layout` and :func:`build_zone_layout` must all agree on
    it, or dense and bucketed layouts would clip (and overflow) at
    different capacities.
    """
    cap = e_cap or plan.max_count
    return max(_round_up(max(cap, 1), pad_edges_to), pad_edges_to)


def build_zone_batch(
    graph: TemporalGraph,
    plan: ZonePlan,
    *,
    e_cap: int | None = None,
    pad_zones_to: int = 1,
    pad_edges_to: int = 8,
    n_shards: int = 1,
    label: str = "",
) -> ZoneBatch:
    """Gather zones into a padded [Z, e_cap] batch with validity masks."""
    z = plan.n_zones
    cap = dense_cap(plan, e_cap=e_cap, pad_edges_to=pad_edges_to)
    z_pad = max(_round_up(max(z, 1), pad_zones_to), pad_zones_to)

    # static load balance: biggest zones first, dealt round-robin over shards
    order = np.argsort(-plan.count, kind="stable")
    if n_shards > 1 and z:
        lanes: list[list[int]] = [[] for _ in range(n_shards)]
        for rank, zi in enumerate(order):
            lanes[rank % n_shards].append(int(zi))
        order = np.asarray([zi for lane in lanes for zi in lane], np.int64)

    u = np.zeros((z_pad, cap), np.int32)
    v = np.zeros((z_pad, cap), np.int32)
    t = np.zeros((z_pad, cap), np.int32)
    valid = np.zeros((z_pad, cap), bool)
    sign = np.zeros(z_pad, np.int32)
    perm = np.full(z_pad, -1, np.int64)
    overflow = 0
    for row, zi in enumerate(order):
        lo = int(plan.lo[zi])
        cnt = int(plan.count[zi])
        take = min(cnt, cap)
        overflow += cnt - take
        fill_zone_row(u[row], v[row], t[row], valid[row],
                      graph.u[lo:lo + take], graph.v[lo:lo + take],
                      graph.t[lo:lo + take])
        sign[row] = plan.sign[zi]
        perm[row] = zi
    return ZoneBatch(u=u, v=v, t=t, valid=valid, sign=sign, perm=perm,
                     overflow=overflow, label=label)


# ---------------------------------------------------------------------------
# Ragged zone batching: size-bucketed layouts.
# ---------------------------------------------------------------------------

ZONE_LAYOUTS = ("auto", "dense", "bucketed")


def next_pow2(x: int) -> int:
    """Smallest power of two >= ``x`` (1 for x <= 1).

    The one copy of the bucket-capacity rounding rule — the streaming
    frontier and the bucketed layout must agree on it, or the same zone
    would land on different batch shapes depending on the path.
    """
    return 1 << max(int(x) - 1, 0).bit_length() if x > 1 else 1


def bucket_caps(counts: np.ndarray, *, max_cap: int,
                pad_edges_to: int = 8) -> np.ndarray:
    """Per-zone bucket capacity: power-of-two ceil, aligned to
    ``pad_edges_to``, clipped to ``max_cap``.

    The floor is ``pad_edges_to`` rounded up to a power of two, so the
    quietest zones still land on device-friendly row widths; aligning to
    ``pad_edges_to`` afterwards keeps each bucket's grouping key equal to
    the ``e_cap`` :func:`build_zone_batch` will actually allocate (for a
    non-power-of-two ``pad_edges_to``, a raw pow2 cap would be re-rounded
    there, merging buckets and mislabeling them); the clip keeps the top
    bucket exactly the dense capacity, so a zone that would overflow the
    dense batch overflows the bucketed one by the same edge count
    (identical ``overflow`` semantics across layouts).
    """
    floor = next_pow2(max(int(pad_edges_to), 1))
    caps = np.asarray(
        [next_pow2(max(int(c), 1)) for c in np.asarray(counts)], np.int64)
    caps = np.maximum(caps, floor)
    caps = (caps + pad_edges_to - 1) // pad_edges_to * pad_edges_to
    return np.clip(caps, None, max_cap)


@dataclasses.dataclass(frozen=True)
class ZoneBatchLayout:
    """A zone batch as one or more size-bucketed :class:`ZoneBatch` pieces.

    ``kind`` is ``"dense"`` (one bucket at the global capacity — the seed
    layout, kept as the differential oracle and for tiny plans) or
    ``"bucketed"`` (zones grouped into power-of-two ``e_cap`` buckets so
    quiet zones stop paying a bursty zone's dense O(e_cap²) sweep).
    Buckets are ordered by ascending capacity and each is a self-contained
    padded batch; signed aggregation is associative over zones (Lemma 4.2),
    so mining buckets independently and merging the partial count tables is
    exact.
    """

    kind: str
    buckets: tuple[ZoneBatch, ...]

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)

    @property
    def n_zones(self) -> int:
        """Planned (real) zones across buckets — pad rows excluded."""
        return sum(b.n_real_zones for b in self.buckets)

    @property
    def overflow(self) -> int:
        return sum(b.overflow for b in self.buckets)

    @property
    def e_cap(self) -> int:
        """Largest bucket capacity (== the dense capacity by construction)."""
        return max((b.e_cap for b in self.buckets), default=0)

    @property
    def valid_edges(self) -> int:
        return sum(b.valid_edges for b in self.buckets)

    @property
    def padded_slots(self) -> int:
        return sum(b.padded_slots for b in self.buckets)

    @property
    def padding_ratio(self) -> float:
        """Fraction of device edge slots that are padding (wasted work)."""
        slots = self.padded_slots
        return 1.0 - self.valid_edges / slots if slots else 0.0

    @property
    def sweep_slots(self) -> int:
        """Padded pairwise sweep work — the dense O(e_cap²) cost model the
        bucketing attacks.  One formula, owned by the planner
        (:func:`repro_torch.core.planner.padded_sweep_slots`)."""
        from . import planner

        return planner.padded_sweep_slots(self.bucket_shapes())

    def bucket_shapes(self) -> tuple[tuple[int, int], ...]:
        """Per-bucket ``(n_zones, e_cap)`` — the compile-cache geometry."""
        return tuple((b.n_zones, b.e_cap) for b in self.buckets)

    def summary(self) -> dict:
        """JSON-able layout description (benchmarks, ``engine.stats``)."""
        return {
            "kind": self.kind,
            "n_zones": self.n_zones,
            "padding_ratio": self.padding_ratio,
            "buckets": [
                {
                    "label": b.label,
                    "e_cap": b.e_cap,
                    "n_zones": b.n_zones,
                    "real_zones": b.n_real_zones,
                    "valid_edges": b.valid_edges,
                    "occupancy": b.occupancy,
                }
                for b in self.buckets
            ],
        }


@dataclasses.dataclass(frozen=True)
class FusedZoneLayout:
    """A :class:`ZoneBatchLayout` flattened into one device slot stream.

    Every bucket's padded ``[Z_b, e_cap_b]`` rows are flattened and
    concatenated into flat ``int32[S]`` arrays (``S`` rounded up to a
    multiple of ``blk``), so a *single* kernel launch can sweep the whole
    ragged layout: candidate blocks of ``blk`` lanes tile the stream and
    the per-block ``[lo, hi)`` descriptors bound each block's sweep to the
    flat span of the zones its lanes belong to.  ``zone_id`` (the global
    zone row per slot, -1 for stream padding) gates the kernel's edge
    updates to same-zone pairs, and ``sign`` carries each slot's Lemma-4.2
    sign so the on-device fold can weight candidates without a host gather.

    ``bounds`` records how ``hi`` was planned: ``"full"`` sweeps each
    block to the blk-aligned end of its lanes' zones, ``"live"`` stops at
    the blk-aligned Lemma-4.1 horizon cut (no lane in the block can absorb
    an edge past ``t_seed + l_max * delta``) and skips candidate blocks
    with no valid lane outright (``lo == hi``).
    """

    u: np.ndarray         # int32[S] flat edge endpoints
    v: np.ndarray         # int32[S]
    t: np.ndarray         # int32[S] timestamps (0 on invalid slots)
    valid: np.ndarray     # int32[S] real-edge mask
    zone_id: np.ndarray   # int32[S] owning zone row (-1 = stream pad)
    sign: np.ndarray      # int32[S] zone sign per slot (0 on pad)
    lo: np.ndarray        # int32[S // blk] blk-aligned sweep start per block
    hi: np.ndarray        # int32[S // blk] blk-aligned sweep end per block
    blk: int
    kind: str                                   # source layout kind
    bucket_shapes: tuple[tuple[int, int], ...]  # source (Z_b, e_cap_b)
    n_zones: int                                # real zones in the stream
    overflow: int
    bounds: str = "full"                        # sweep-bound planning mode

    @property
    def n_slots(self) -> int:
        return int(self.u.shape[0])

    @property
    def n_blocks(self) -> int:
        return self.n_slots // self.blk

    @property
    def valid_edges(self) -> int:
        return int((self.valid != 0).sum())

    @property
    def sweep_slots(self) -> int:
        """Padded pairwise sweep work actually dispatched: each candidate
        block sweeps ``hi - lo`` slots (before chunk-level live skipping).
        The fused analog of :attr:`ZoneBatchLayout.sweep_slots`; one
        formula, owned by the planner
        (:func:`repro_torch.core.planner.fused_sweep_slots`)."""
        from . import planner

        return planner.fused_sweep_slots(self.lo, self.hi, self.blk)

    def signature(self) -> tuple:
        """The stream's geometry as a cache key.

        ``bounds`` is part of the key — full and live plans dispatch the
        same shapes but different descriptor contents.
        """
        return (self.kind, self.bucket_shapes, self.n_slots, self.blk,
                self.bounds)

    def summary(self) -> dict:
        """JSON-able description (benchmarks, ``engine.stats``)."""
        return {
            "kind": f"fused-{self.kind}",
            "bounds": self.bounds,
            "n_zones": self.n_zones,
            "n_slots": self.n_slots,
            "blk": self.blk,
            "n_blocks": self.n_blocks,
            "valid_edges": self.valid_edges,
            "sweep_slots": self.sweep_slots,
            "bucket_shapes": [list(s) for s in self.bucket_shapes],
        }


#: Sweep-bound planning modes for :func:`concat_layout`.
FUSED_BOUNDS = ("full", "live")


def concat_layout(layout: ZoneBatchLayout, *, blk: int = 512,
                  pad_slots_to: int | None = None,
                  delta: int | None = None, l_max: int | None = None,
                  bounds: str = "full") -> FusedZoneLayout:
    """Flatten a (dense or bucketed) layout into a fused slot stream.

    Buckets are visited in layout order (ascending capacity) and only real
    zone rows (``perm >= 0``) are emitted — inert zone-padding rows would
    be pure wasted sweep in a stream that has no rectangular shape to
    satisfy.  The stream is padded to a multiple of ``blk`` (and of
    ``pad_slots_to`` when given — the executor passes its on-device fold
    chunk so the count fold tiles evenly); padding slots carry ``valid=0``,
    ``zone_id=-1``, ``sign=0``.

    ``bounds="full"``: ``hi[i]`` is the blk-aligned end of the last zone
    any of block ``i``'s lanes belongs to — a lane's extensions can only
    come from later slots of its own zone row (earlier same-zone edges are
    not strictly later in time, so they can neither extend nor time out
    the candidate), hence sweeping ``[i*blk, hi[i])`` is exact.

    ``bounds="live"`` (requires ``delta``/``l_max``): tighten ``hi[i]`` to
    the blk-aligned Lemma-4.1 horizon cut.  A candidate seeded at ``t0``
    extends only through edges with ``t <= t0 + l_max * delta`` (after
    ``k`` extensions ``last_t <= t0 + k * delta``, and an extension needs
    ``t <= last_t + delta`` with ``length < l_max``); zone rows are
    time-sorted, so one ``searchsorted`` per valid slot places its cut
    exactly.  Edges past the cut can only set the candidate's ``done``
    flag, which never feeds the ``code``/``length``/``ts`` outputs, so the
    compacted sweep is output-identical to the full one.  Blocks with no
    valid lane get ``hi == lo`` (zero chunks dispatched).  ``lo[i]`` is
    ``i * blk`` in both modes: seeding lane ``q`` requires sweeping slot
    ``q`` itself, and every cut is ``>= q + 1``, so a live block's window
    always covers its own chunk.
    """
    if blk < 1:
        raise ValueError(f"blk must be >= 1, got {blk}")
    if bounds not in FUSED_BOUNDS:
        raise ValueError(
            f"unknown fused sweep bounds {bounds!r}; one of {FUSED_BOUNDS}")
    if bounds == "live" and (delta is None or l_max is None):
        raise ValueError(
            "bounds='live' needs delta and l_max to place the Lemma-4.1 "
            "horizon cut")
    mult = blk
    if pad_slots_to:
        if pad_slots_to % blk:
            raise ValueError(
                f"pad_slots_to {pad_slots_to} must be a multiple of "
                f"blk {blk}")
        mult = pad_slots_to

    horizon = int(delta) * int(l_max) if bounds == "live" else 0
    chunks_u, chunks_v, chunks_t, chunks_valid = [], [], [], []
    chunks_zid, chunks_sign, row_ends, live_ends = [], [], [], []
    zone_row = 0
    pos = 0
    for b in layout.buckets:
        real = np.flatnonzero(b.perm >= 0)
        cap = b.e_cap
        for r in real:
            chunks_u.append(b.u[r])
            chunks_v.append(b.v[r])
            chunks_t.append(b.t[r])
            chunks_valid.append(b.valid[r])
            chunks_zid.append(np.full(cap, zone_row, np.int32))
            chunks_sign.append(np.full(cap, b.sign[r], np.int32))
            row_start = pos
            pos += cap
            row_ends.append(np.full(cap, pos, np.int64))
            if bounds == "live":
                # per-slot horizon cut (int64 guards t + horizon overflow);
                # invalid slots contribute 0 — they seed nothing, so they
                # constrain no block's window
                cnt = int(b.valid[r].sum())
                cuts = np.zeros(cap, np.int64)
                if cnt:
                    st = b.t[r][:cnt].astype(np.int64)
                    cuts[:cnt] = row_start + np.searchsorted(
                        st, st + horizon, side="right")
                live_ends.append(cuts)
            zone_row += 1

    s = pos
    s_pad = max(_round_up(max(s, 1), mult), mult)
    pad = s_pad - s

    def flat(parts, fill, dtype):
        out = np.concatenate(parts).astype(dtype) if parts else \
            np.zeros(0, dtype)
        if pad:
            out = np.concatenate([out, np.full(pad, fill, dtype)])
        return out

    u = flat(chunks_u, 0, np.int32)
    v = flat(chunks_v, 0, np.int32)
    t = flat(chunks_t, 0, np.int32)
    valid = flat(chunks_valid, 0, np.int32)
    zone_id = flat(chunks_zid, -1, np.int32)
    sign = flat(chunks_sign, 0, np.int32)
    # pad slots end at their own position so they never extend a sweep
    slot_end = np.concatenate(row_ends).astype(np.int64) if row_ends else \
        np.zeros(0, np.int64)
    if pad:
        slot_end = np.concatenate(
            [slot_end, np.arange(s, s_pad, dtype=np.int64) + 1])

    n_blocks = s_pad // blk
    bases = np.arange(n_blocks, dtype=np.int64) * blk
    if bounds == "live":
        live = np.concatenate(live_ends).astype(np.int64) if live_ends \
            else np.zeros(0, np.int64)
        if pad:
            live = np.concatenate([live, np.zeros(pad, np.int64)])
        cut = live.reshape(n_blocks, blk).max(axis=1)
        hi = (cut + blk - 1) // blk * blk
        # blocks with no valid lane dispatch zero chunks (their lanes seed
        # nothing and the fold zero-weights length-0 candidates)
        hi = np.where(cut > 0, hi, bases)
    else:
        hi = slot_end.reshape(n_blocks, blk).max(axis=1)
        hi = (hi + blk - 1) // blk * blk

    return FusedZoneLayout(
        u=u, v=v, t=t, valid=valid, zone_id=zone_id, sign=sign,
        lo=bases.astype(np.int32), hi=hi.astype(np.int32), blk=blk,
        kind=layout.kind, bucket_shapes=layout.bucket_shapes(),
        n_zones=zone_row, overflow=layout.overflow, bounds=bounds,
    )


def _select_plan(plan: ZonePlan, idx: np.ndarray) -> ZonePlan:
    return ZonePlan(lo=plan.lo[idx], count=plan.count[idx],
                    sign=plan.sign[idx], t_start=plan.t_start[idx],
                    t_end=plan.t_end[idx], l_b=plan.l_b)


def resolve_layout(plan: ZonePlan, layout: str, *, e_cap: int | None = None,
                   pad_edges_to: int = 8) -> str:
    """Resolve ``"auto"`` to a concrete layout kind for ``plan``.

    ``auto`` picks ``bucketed`` only when the plan's zone sizes actually
    span more than one bucket — a uniform (or tiny) plan gains nothing
    from bucketing and the dense layout keeps one executable shape.
    """
    if layout not in ZONE_LAYOUTS:
        raise ValueError(
            f"unknown zone layout {layout!r}; one of {ZONE_LAYOUTS}")
    if layout != "auto":
        return layout
    if plan.n_zones < 2:
        return "dense"
    counts = np.asarray(plan.count)
    if (counts == 0).any():
        # the bucketed layout drops empty zones outright — always a win
        return "bucketed"
    caps = bucket_caps(counts,
                       max_cap=dense_cap(plan, e_cap=e_cap,
                                         pad_edges_to=pad_edges_to),
                       pad_edges_to=pad_edges_to)
    return "bucketed" if len(np.unique(caps)) > 1 else "dense"


def build_zone_layout(
    graph: TemporalGraph,
    plan: ZonePlan,
    *,
    layout: str = "auto",
    e_cap: int | None = None,
    pad_zones_to: int = 1,
    pad_edges_to: int = 8,
    n_shards: int = 1,
) -> ZoneBatchLayout:
    """Build a device layout for ``plan`` — dense or size-bucketed.

    The bucketed layout groups zones whose edge population rounds up to the
    same power-of-two capacity into one padded batch per bucket (largest
    bucket capped at the dense capacity, so overflow is layout-invariant).
    Empty zones are dropped outright — a zone with no edges seeds no
    candidates, so its signed contribution is identically zero (quiet-gap
    plans routinely carry thousands of them, all padding under the dense
    layout).  Zone ordering inside a bucket keeps
    :func:`build_zone_batch`'s static load balancing (descending size,
    round-robin over ``n_shards``), and ``perm`` is remapped to the
    original plan's zone indices.
    """
    kind = resolve_layout(plan, layout, e_cap=e_cap,
                          pad_edges_to=pad_edges_to)
    if kind == "dense":
        dense = build_zone_batch(
            graph, plan, e_cap=e_cap, pad_zones_to=pad_zones_to,
            pad_edges_to=pad_edges_to, n_shards=n_shards, label="dense")
        return ZoneBatchLayout(kind="dense", buckets=(dense,))

    max_cap = dense_cap(plan, e_cap=e_cap, pad_edges_to=pad_edges_to)
    nonempty = np.flatnonzero(np.asarray(plan.count) > 0)
    if nonempty.size == 0:
        # all-empty plan: one inert bucket so the executor still has a
        # (zero-candidate) batch to run — counts come out empty, exactly.
        # Zone padding/sharding kwargs still apply: a mesh path must be
        # able to partition even an empty batch's zone axis.
        inert = build_zone_batch(
            graph, _select_plan(plan, nonempty), e_cap=pad_edges_to,
            pad_zones_to=pad_zones_to, pad_edges_to=pad_edges_to,
            n_shards=n_shards, label=f"cap{pad_edges_to}")
        return ZoneBatchLayout(kind="bucketed", buckets=(inert,))
    caps = bucket_caps(plan.count[nonempty], max_cap=max_cap,
                       pad_edges_to=pad_edges_to)
    buckets = []
    for cap in sorted(int(c) for c in np.unique(caps)):
        idx = nonempty[np.flatnonzero(caps == cap)]
        sub = _select_plan(plan, idx)
        batch = build_zone_batch(
            graph, sub, e_cap=cap, pad_zones_to=pad_zones_to,
            pad_edges_to=pad_edges_to, n_shards=n_shards,
            label=f"cap{cap}")
        # remap perm from sub-plan rows back to the original zone indices
        perm = np.where(batch.perm >= 0,
                        idx[np.clip(batch.perm, 0, len(idx) - 1)], -1)
        buckets.append(dataclasses.replace(batch, perm=perm))
    return ZoneBatchLayout(kind="bucketed", buckets=tuple(buckets))
