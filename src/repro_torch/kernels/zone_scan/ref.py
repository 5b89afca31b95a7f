"""Plain PyTorch version of the fused flat zone scan.

The counterpart of the JAX package's compiled lowering
(``fused_zone_scan_xla``): same contract as the hand-written CUDA kernel in
``csrc/fused_zone_scan.cu`` — flat ``int32[S]`` slot streams plus
per-block ``[lo, hi)`` descriptors in, ``(code int32[S, L], length
int32[S])`` out, plus ``ts int32[S, l_max]`` absorption timestamps with
``with_ts`` — written as ordinary tensor ops so it runs on any device.
The CPU tests hold it against the JAX package; on the card it is the
version each kernel launch is compared with.  It repeats the kernel's
arithmetic and is no yardstick of speed.

:func:`_edge_update` is this package's torch copy of the Definition 2-5
transition rule for a block of lanes (the kernel's per-lane copy lives in
``csrc/edge_update.cuh``).

Loop structure:

* each lane ``q`` sweeps its own row window ``[q, win_end)``: the row end
  is the next row start, found once for the whole stream by a reverse
  ``cummin`` over row-start markers of the sorted ``zone_id`` stream, and
  ``win_end`` is clipped by the lane's block descriptor ``hi``, so
  host-planned live bounds (``bounds="live"``) shrink the trip directly.
  Edges past the cut could only set ``done``, which never feeds the
  outputs, so the clip is output-exact.  The compiled JAX lowering starts
  each lane at its row start instead; starting at the lane's own slot is
  exact too — before its seed a lane has ``length == 0``, so it is
  inactive and no edge touches it — and it cuts the trip from the row
  length to the live window;
* all lanes advance in **lockstep**: step ``j`` applies slot ``q + j`` to
  every live lane ``q``.  Every few steps the lanes whose sweep is over
  write their outputs and leave the lockstep set, so a step costs what the
  lanes still sweeping need rather than the whole stream (the JAX lowering
  runs fixed cache-sized segments for the longest window of each instead).

``early_exit`` (the default, as in the kernel) is the masked form of the
kernel's per-lane early exit:
a lane ignores every later edge once ``done`` is set or ``length ==
l_max`` — after either, no edge can change ``code`` or ``length`` (a
time-out only sets ``done``, which the outputs never read), so the lane
retires early.  Its outputs equal the unmasked sweep's; :func:`lane_steps`
counts the slots the masked sweep visits, which is the work one kernel
thread per lane does.
"""

from __future__ import annotations

import torch

from repro_torch.core import encoding

#: lockstep steps between retirements of finished lanes
_RETIRE_EVERY = 16


def _edge_update(state, *, u, v, t, seed, gate, delta, l_max, iota_k,
                 li_iota, iota_l=None):
    """Apply one edge per lane to a block of lanes' expansion state.

    ``state`` is ``(length, last_t, done, n_nodes, nodes, code)``: int32
    ``[C]`` vectors (``done`` bool), ``nodes [K, C]``, ``code [L, C]``,
    plus a trailing ``ts [l_max, C]`` block of absorption timestamps when
    ``iota_l`` (the ``[l_max, 1]`` int32 step index) is given.
    ``u, v, t`` are this step's per-lane edge values ``[C]``; ``seed`` marks
    lanes seeded by this edge (already gated on its validity) and ``gate``
    the lanes this edge may extend or time out (validity and same zone).
    ``iota_k``/``li_iota`` are ``[K, 1]``/``[L, 1]`` int32 row indices.
    """
    length, last_t, done, n_nodes, nodes, code = state[:6]
    k = iota_k.shape[0]

    active = (length > 0) & ~done
    gap = t - last_t
    gap_ok = (t > last_t) & (gap <= delta)
    timed_out = active & (gap > delta) & gate

    u_hit = nodes == u
    v_hit = nodes == v
    u_in = u_hit.any(dim=0)
    v_in = v_hit.any(dim=0)
    extend = (active & ~timed_out & gap_ok & (length < l_max)
              & (u_in | v_in) & gate)

    u_pos = torch.where(u_hit, iota_k, k).amin(dim=0)
    v_pos = torch.where(v_hit, iota_k, k).amin(dim=0)
    label_u = torch.where(u_in, u_pos, n_nodes)
    nn1 = n_nodes + (~u_in).to(torch.int32)
    same_uv = u == v
    label_v = torch.where(same_uv, label_u, torch.where(v_in, v_pos, nn1))
    nn2 = torch.where(same_uv, nn1, nn1 + (~v_in).to(torch.int32))

    put_u = extend & ~u_in
    put_v = extend & ~v_in & ~same_uv
    nodes = torch.where(put_u & (iota_k == n_nodes), u, nodes)
    nodes = torch.where(put_v & (iota_k == nn1), v, nodes)

    # append the two digits (label+1) at positions 2*len, 2*len+1
    zero = torch.zeros_like(length)
    for which, label in ((0, label_u), (1, label_v)):
        pos = 2 * length + which
        limb_idx = torch.div(pos, encoding.DIGITS_PER_LIMB,
                             rounding_mode="floor")
        shift = 4 * (encoding.DIGITS_PER_LIMB - 1
                     - pos % encoding.DIGITS_PER_LIMB)
        add = torch.where(extend,
                          torch.bitwise_left_shift(label + 1, shift), zero)
        code = code + torch.where(li_iota == limb_idx, add, 0)

    new_length = length + extend.to(torch.int32)
    new_last_t = torch.where(extend, t, last_t)
    new_nn = torch.where(extend, nn2, n_nodes)

    # seed the candidate owned by this edge
    seed_nn = torch.where(same_uv, 1, 2).to(torch.int32)
    new_length = torch.where(seed, 1, new_length)
    new_last_t = torch.where(seed, t, new_last_t)
    new_nn = torch.where(seed, seed_nn, new_nn)
    nodes = torch.where(seed & (iota_k == 0), u, nodes)
    nodes = torch.where(seed & (iota_k == 1) & ~same_uv, v, nodes)
    seed_digit0 = 1 << (4 * (encoding.DIGITS_PER_LIMB - 1))
    seed_digit1 = torch.bitwise_left_shift(
        seed_nn, 4 * (encoding.DIGITS_PER_LIMB - 2))
    seed_code = torch.where(li_iota == 0, seed_digit0 + seed_digit1, 0)
    code = torch.where(seed, seed_code, code)

    out = (new_length, new_last_t, done | timed_out, new_nn, nodes, code)
    if iota_l is None:
        return out
    # the edge's time lands at step `length` (before the increment) on an
    # extension, at step 0 on a seed
    ts = torch.where(extend & (iota_l == length), t, state[6])
    ts = torch.where(seed & (iota_l == 0), t, ts)
    return out + (ts,)


def check_flat_inputs(u, v, t, valid, zone_id, lo, hi, *, blk: int) -> int:
    """Shape checks shared by the kernel wrapper and the plain version;
    returns the number of candidate blocks."""
    s_pad = u.shape[0]
    if s_pad % blk:
        raise ValueError(
            f"flat slot count {s_pad} is not a multiple of blk {blk}")
    for name, x in (("v", v), ("t", t), ("valid", valid),
                    ("zone_id", zone_id)):
        if tuple(x.shape) != (s_pad,):
            raise ValueError(
                f"{name} has shape {tuple(x.shape)}, expected ({s_pad},)")
    n_blocks = s_pad // blk
    if lo.shape[0] != n_blocks or hi.shape[0] != n_blocks:
        raise ValueError(
            f"descriptors (lo: {lo.shape[0]}, hi: {hi.shape[0]}) do not "
            f"match {n_blocks} candidate blocks")
    return n_blocks


def lane_windows(zone_id, hi, *, blk: int) -> torch.Tensor:
    """Per lane ``q``, one past the last slot its sweep may read: the end
    of its zone row (the next row start), clipped by its block's ``hi``."""
    s_pad = zone_id.shape[0]
    iota_s = torch.arange(s_pad, dtype=torch.int64, device=zone_id.device)
    is_start = torch.ones(s_pad, dtype=torch.bool, device=zone_id.device)
    is_start[1:] = zone_id[1:] != zone_id[:-1]
    start_or_end = torch.where(is_start, iota_s, s_pad)
    next_start = torch.flip(
        torch.cummin(torch.flip(start_or_end, (0,)), 0).values, (0,))
    row_end = torch.full_like(iota_s, s_pad)
    row_end[:-1] = next_start[1:]
    return torch.minimum(row_end, hi.to(torch.int64)[iota_s // blk])


def _scan(u, v, t, valid, zone_id, lo, hi, *, delta, l_max, blk,
          early_exit, with_ts=False):
    """The sweep behind :func:`fused_zone_scan_torch` and
    :func:`lane_steps`; returns ``(code, length, ts, steps)`` (``ts`` is
    None without ``with_ts``; ``steps int64[S]``, the slots each lane
    visits with ``early_exit``)."""
    check_flat_inputs(u, v, t, valid, zone_id, lo, hi, blk=blk)
    s_pad = u.shape[0]
    dev = u.device
    limbs = encoding.n_limbs(l_max)
    k = l_max + 1
    u, v, t, zid = (x.to(torch.int32) for x in (u, v, t, zone_id))
    ok = valid != 0
    span = lane_windows(zid, hi, blk=blk) - torch.arange(
        s_pad, dtype=torch.int64, device=dev)
    code = torch.zeros((s_pad, limbs), dtype=torch.int32, device=dev)
    length = torch.zeros(s_pad, dtype=torch.int32, device=dev)
    ts = (torch.zeros((s_pad, l_max), dtype=torch.int32, device=dev)
          if with_ts else None)
    steps = torch.zeros(s_pad, dtype=torch.int64, device=dev)

    # only lanes that can seed (own slot valid, inside its window) sweep
    lanes = torch.nonzero(ok & (span > 0)).flatten()
    l_span = span[lanes]
    trip = int(l_span.max()) if lanes.numel() else 0
    pad_i = lambda x, fill: torch.cat(
        [x, torch.full((trip,), fill, dtype=x.dtype, device=dev)])
    u_p, v_p, t_p = pad_i(u, 0), pad_i(v, 0), pad_i(t, 0)
    ok_p, zid_p = pad_i(ok, False), pad_i(zid, -1)
    l_zid = zid[lanes]
    l_steps = torch.zeros(lanes.numel(), dtype=torch.int64, device=dev)

    n = lanes.numel()
    state = (
        torch.zeros(n, dtype=torch.int32, device=dev),            # length
        torch.zeros(n, dtype=torch.int32, device=dev),            # last_t
        torch.zeros(n, dtype=torch.bool, device=dev),             # done
        torch.zeros(n, dtype=torch.int32, device=dev),            # n_nodes
        torch.full((k, n), -1, dtype=torch.int32, device=dev),    # nodes
        torch.zeros((limbs, n), dtype=torch.int32, device=dev),   # code
    )
    iota_k = torch.arange(k, dtype=torch.int32, device=dev)[:, None]
    li_iota = torch.arange(limbs, dtype=torch.int32, device=dev)[:, None]
    iota_l = None
    if with_ts:
        state += (torch.zeros((l_max, n), dtype=torch.int32, device=dev),)
        iota_l = torch.arange(l_max, dtype=torch.int32, device=dev)[:, None]

    def flush(sel):
        # a retired lane keeps the timestamps it had
        q = lanes[sel]
        steps[q] = l_steps[sel]
        length[q] = state[0][sel]
        code[q] = state[5][:, sel].T
        if with_ts:
            ts[q] = state[6][:, sel].T

    j = 0
    while j < trip:
        act = j < l_span
        if early_exit:
            act = act & ~state[2] & (state[0] < l_max)
        if j and j % _RETIRE_EVERY == 0:
            # retire lanes whose sweep is over: write their outputs and
            # drop them from the lockstep set
            if not bool(act.all()):
                keep = act
                flush(~keep)
                lanes, l_span, l_zid, l_steps, act = (x[keep] for x in (
                    lanes, l_span, l_zid, l_steps, act))
                state = tuple(x[..., keep] for x in state)
                trip = int(l_span.max()) if lanes.numel() else 0
                if j >= trip:
                    break
        if early_exit:
            l_steps += act
        idx = lanes + j
        evalid = act & ok_p[idx]
        state = _edge_update(
            state, u=u_p[idx], v=v_p[idx], t=t_p[idx],
            seed=evalid if j == 0 else torch.zeros_like(evalid),
            gate=evalid & (zid_p[idx] == l_zid),
            delta=delta, l_max=l_max, iota_k=iota_k, li_iota=li_iota,
            iota_l=iota_l)
        j += 1
    flush(torch.ones(lanes.numel(), dtype=torch.bool, device=dev))
    return code, length, ts, steps


def fused_zone_scan_torch(u, v, t, valid, zone_id, lo, hi, *, delta: int,
                          l_max: int, blk: int = 512,
                          early_exit: bool = True, with_ts: bool = False):
    """Single-launch ragged zone scan over a concatenated flat slot stream.

    Args and returns are those of the CUDA kernel's wrapper
    (:func:`repro_torch.kernels.zone_scan.ops.scan_flat`): flat
    ``int32[S]`` slot streams plus per-block ``[lo, hi)`` descriptors in,
    ``(code int32[S, L], length int32[S])`` out, plus ``ts int32[S,
    l_max]`` absorption timestamps with ``with_ts``, on the inputs'
    device.
    """
    code, length, ts, _ = _scan(u, v, t, valid, zone_id, lo, hi,
                                delta=delta, l_max=l_max, blk=blk,
                                early_exit=early_exit, with_ts=with_ts)
    return (code, length, ts) if with_ts else (code, length)


def lane_steps(u, v, t, valid, zone_id, lo, hi, *, delta: int, l_max: int,
               blk: int = 512) -> torch.Tensor:
    """Slots visited by the early-exit sweep of each lane, its seed slot
    included (``int64[S]``, 0 for a lane that does not seed): the steps
    one kernel thread per lane takes on these inputs."""
    *_, steps = _scan(u, v, t, valid, zone_id, lo, hi, delta=delta,
                      l_max=l_max, blk=blk, early_exit=True)
    return steps


def live_steps(u, v, t, valid, zone_id, lo, hi, *, delta: int, l_max: int,
               blk: int = 512) -> int:
    """Slots visited by the early-exit sweep, summed over lanes: the
    per-lane steps these inputs need (one kernel thread per lane visits
    exactly these)."""
    return int(lane_steps(u, v, t, valid, zone_id, lo, hi, delta=delta,
                          l_max=l_max, blk=blk).sum())
