"""Phase 1 — growth-zone candidate expansion (vectorized torch reference).

The paper's ``try_to_transit`` loop, re-thought for SIMD execution:

* Definition 3 makes the successor of a motif unique ("no earlier valid
  transition"), so processes never fork.  Candidate *i* is therefore exactly
  the process seeded by edge *i* — a static, allocator-free table.
* Edges are consumed in stream order by a Python loop; each step does one
  dense vector sweep over the ``[Z, C]`` candidate table (extension test +
  relabeling encode).  A zone batch is an explicit leading ``Z`` axis.

State (structure-of-arrays over ``[Z, C]`` candidates):
  ``length``  int32[Z, C]     edges absorbed so far (0 = not yet seeded)
  ``last_t``  int32[Z, C]     timestamp of the newest edge
  ``done``    bool[Z, C]      timed out (frozen forever)
  ``n_nodes`` int32[Z, C]     node-table population
  ``nodes``   int32[Z, C, K]  first-occurrence node table, K = l_max + 1,
                              -1 = empty
  ``code``    int32[Z, C, L]  multi-limb relabeling code (see core.encoding)
  ``ts``      int32[Z, C, l_max] per-step absorption timestamps
                              (``with_ts`` only; ``ts[..., k]`` is the
                              time of the k-th absorbed edge, ``ts[..., 0]``
                              the seed time).  The config-lattice co-mining
                              path derives every smaller ``(delta, l_max)``
                              config's counts from one dominating sweep by
                              prefix-truncating candidates on these
                              timestamps (:func:`derive_lengths`).

Each step only touches the candidate columns whose outputs the edge can
still change: columns past the edge's own slot are not seeded yet, and a
candidate seeded at ``t0`` can only absorb edges with ``t <= t0 + l_max *
delta`` (Lemma 4.1) — a later edge at most sets its ``done`` flag, which
never feeds ``code``/``length``.  Zone rows are time-sorted, so that live
set is a contiguous column window found by one ``searchsorted``; rows that
are not time-sorted fall back to the full width.  The outputs are those of
the full-width sweep.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import encoding


class ZoneState(NamedTuple):
    length: torch.Tensor
    last_t: torch.Tensor
    done: torch.Tensor
    n_nodes: torch.Tensor
    nodes: torch.Tensor
    code: torch.Tensor
    ts: torch.Tensor | None = None


class ZoneResult(NamedTuple):
    """Final per-candidate codes of a zone batch (candidate i = seed
    edge i)."""

    code: torch.Tensor     # int32[..., C, L]
    length: torch.Tensor   # int32[..., C] (0 for padding slots)
    ts: torch.Tensor | None = None   # int32[..., C, l_max] (``with_ts``)


def init_state(z: int, e_cap: int, l_max: int, *, device,
               with_ts: bool = False) -> ZoneState:
    k = l_max + 1
    shape = (z, e_cap)
    return ZoneState(
        length=torch.zeros(shape, dtype=torch.int32, device=device),
        last_t=torch.zeros(shape, dtype=torch.int32, device=device),
        done=torch.zeros(shape, dtype=torch.bool, device=device),
        n_nodes=torch.zeros(shape, dtype=torch.int32, device=device),
        nodes=torch.full((*shape, k), -1, dtype=torch.int32, device=device),
        code=encoding.empty_code(shape, l_max, device=device),
        ts=(torch.zeros((*shape, l_max), dtype=torch.int32, device=device)
            if with_ts else None),
    )


def step(state: ZoneState, edge, *, delta: int, l_max: int,
         col0: int = 0) -> ZoneState:
    """Absorb one edge per zone: time-outs, extensions, then the seed.

    ``state`` holds candidate columns ``[col0, col0 + C)`` of a ``[Z, *]``
    table; ``edge = (u, v, t, valid, slot)`` with ``u/v/t/valid`` of shape
    ``[Z]`` (zone ``z``'s edge at stream index ``slot``).
    """
    u, v, t, valid, slot = (x[:, None] if torch.is_tensor(x) else x
                            for x in edge)
    z, c = state.length.shape
    dev = state.length.device

    active = (state.length > 0) & ~state.done
    gap = t - state.last_t
    gap_ok = (t > state.last_t) & (gap <= delta)
    timed_out = active & (gap > delta) & valid
    done = state.done | timed_out

    u_hit = state.nodes == u[..., None]
    v_hit = state.nodes == v[..., None]
    u_in = u_hit.any(dim=2)
    v_in = v_hit.any(dim=2)
    extend = (
        active & ~timed_out & gap_ok & (state.length < l_max)
        & (u_in | v_in) & valid
    )

    # first-occurrence relabeling (Phase 3 encoding, fused into the sweep)
    k = state.nodes.shape[2]
    k_iota = torch.arange(k, dtype=torch.int32, device=dev)
    first = lambda hit: torch.where(hit, k_iota, k).amin(dim=2)
    label_u = torch.where(u_in, first(u_hit), state.n_nodes)
    nn1 = state.n_nodes + (~u_in).to(torch.int32)
    same_uv = u == v
    label_v = torch.where(same_uv, label_u,
                          torch.where(v_in, first(v_hit), nn1))
    nn2 = torch.where(same_uv, nn1, nn1 + (~v_in).to(torch.int32))

    put_u = extend & ~u_in
    put_v = extend & ~v_in & ~same_uv
    nodes = torch.where(
        put_u[..., None] & (k_iota == state.n_nodes[..., None]),
        u[..., None], state.nodes)
    nodes = torch.where(
        put_v[..., None] & (k_iota == nn1[..., None]), v[..., None], nodes)

    pos = 2 * state.length
    zero = torch.zeros_like(label_u)
    code = encoding.append_digit(
        state.code, pos, torch.where(extend, label_u + 1, zero))
    code = encoding.append_digit(
        code, pos + 1, torch.where(extend, label_v + 1, zero))

    length = state.length + extend.to(torch.int32)
    last_t = torch.where(extend, t, state.last_t)
    n_nodes = torch.where(extend, nn2, state.n_nodes)
    ts = state.ts
    if ts is not None:
        # an extension records this edge's time at step `length` (before
        # the increment)
        step_iota = torch.arange(ts.shape[2], dtype=torch.int32, device=dev)
        ts = torch.where(
            extend[..., None] & (step_iota == state.length[..., None]),
            t[..., None], ts)

    # seed the candidate owned by this edge (slot == stream index): one
    # column of the window, written in place into the fresh tensors above
    i = slot - col0
    if 0 <= i < c:
        seed, same = valid[:, 0], same_uv[:, 0]
        seed_nn = 2 - same.to(torch.int32)
        length[:, i] = torch.where(seed, 1, length[:, i])
        last_t[:, i] = torch.where(seed, t[:, 0], last_t[:, i])
        n_nodes[:, i] = torch.where(seed, seed_nn, n_nodes[:, i])
        nodes[:, i, 0] = torch.where(seed, u[:, 0], nodes[:, i, 0])
        nodes[:, i, 1] = torch.where(seed & ~same, v[:, 0], nodes[:, i, 1])
        seed_code = encoding.append_digit(
            encoding.empty_code((z,), l_max, device=dev),
            torch.zeros(z, dtype=torch.int32, device=dev),
            torch.ones(z, dtype=torch.int32, device=dev))
        seed_code = encoding.append_digit(
            seed_code, torch.ones(z, dtype=torch.int32, device=dev),
            seed_nn)
        code[:, i] = torch.where(seed[:, None], seed_code, code[:, i])
        if ts is not None:
            ts[:, i, 0] = torch.where(seed, t[:, 0], ts[:, i, 0])

    return ZoneState(length=length, last_t=last_t, done=done,
                     n_nodes=n_nodes, nodes=nodes, code=code, ts=ts)


def _live_starts(t, valid, horizon: int) -> list[int]:
    """Per stream index ``j``, the first candidate column edge ``j`` can
    still change in any zone (see module docstring)."""
    z, e = t.shape
    t64 = t.to(torch.int64)
    starts = torch.searchsorted(t64.contiguous(),
                                (t64 - horizon).contiguous(), side="left")
    if e > 1:
        unsorted = (t64[:, 1:] < t64[:, :-1]).any(dim=1)
        starts = torch.where(unsorted[:, None], 0, starts)
    return starts.amin(dim=0).tolist()


def scan_zones(u, v, t, valid, *, delta: int, l_max: int,
               with_ts: bool = False) -> ZoneResult:
    """Run the full expansion over a ``[Z, E]`` padded zone batch.

    The plain version of the dense CUDA kernel
    (``kernels/zone_scan/csrc/zone_scan.cu``) and the ``ref`` backend's
    scan.

    Args:
      u, v, t: int32[Z, E] padded edge streams (time-ordered within a zone).
      valid:   bool[Z, E] real-edge mask.
      with_ts: also return per-step absorption timestamps (the co-mining
        path's input).
    Returns:
      ZoneResult with per-seed final codes ``[Z, E, L]``, lengths
      ``[Z, E]`` and, with ``with_ts``, timestamps ``[Z, E, l_max]``;
      padding slots have length 0 and all-zero codes and timestamps.
    """
    z, e_cap = u.shape
    dev = u.device
    u, v, t = (x.to(torch.int32) for x in (u, v, t))
    valid = valid.to(torch.bool)
    full = init_state(z, e_cap, l_max, device=dev, with_ts=with_ts)
    if z == 0 or e_cap == 0:
        return ZoneResult(code=full.code, length=full.length, ts=full.ts)
    starts = _live_starts(t, valid, int(delta) * int(l_max))
    any_valid = valid.any(dim=0).tolist()
    for j in range(e_cap):
        if not any_valid[j]:
            continue        # an invalid edge changes no candidate
        a, b = starts[j], j + 1
        part = ZoneState(*(None if x is None else x[:, a:b] for x in full))
        new = step(part, (u[:, j], v[:, j], t[:, j], valid[:, j], j),
                   delta=delta, l_max=l_max, col0=a)
        for dst, src in zip(full, new):
            if dst is not None:
                dst[:, a:b] = src
    return ZoneResult(code=full.code, length=full.length, ts=full.ts)


def scan_zone(u, v, t, valid, *, delta: int, l_max: int,
              with_ts: bool = False) -> ZoneResult:
    """:func:`scan_zones` over one zone's padded ``[E]`` edge stream."""
    res = scan_zones(u[None], v[None], t[None], valid[None], delta=delta,
                     l_max=l_max, with_ts=with_ts)
    return ZoneResult(*(None if x is None else x[0] for x in res))


def derive_lengths(length, ts, *, delta: int, l_max: int):
    """Prefix length of each dominating-sweep candidate under a smaller
    config.

    The config-lattice co-mining lemma: zone streams are time-sorted, so
    for ``delta <= delta_dom`` and ``l_max <= l_max_dom`` the process the
    smaller config would have mined for a candidate is exactly the longest
    prefix of the dominating config's absorbed edge sequence in which
    every consecutive absorption gap ``ts[k] - ts[k-1]`` is ``<= delta``,
    capped at ``l_max`` edges.

    Args:
      length: int32[...] dominating-sweep process lengths.
      ts:     int32[..., l_max_dom] absorption timestamps (``with_ts``).
    Returns:
      int32[...] prefix lengths under ``(delta, l_max)``; 0 stays 0.
    """
    l_dom = ts.shape[-1]
    if l_dom > 1:
        steps = torch.arange(1, l_dom, dtype=torch.int32, device=ts.device)
        gaps = ts[..., 1:] - ts[..., :-1]
        ok = (steps < length[..., None]) & (gaps <= delta)
        run = torch.cumprod(ok.to(torch.int32), dim=-1,
                            dtype=torch.int32).sum(dim=-1)
    else:
        run = torch.zeros_like(length)
    out = torch.clamp(1 + run, max=l_max).to(torch.int32)
    return torch.where(length > 0, out, 0)
