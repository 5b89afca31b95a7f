"""Plain PyTorch reference of PTMT's count table.

The semantics are the paper's (Definitions 2-5), stated on the edge stream
itself, with no zone plan:

* every edge seeds one process, which starts as that one edge;
* a process whose newest edge has time ``t_l`` absorbs the first later
  edge of its stream with ``t_l < t <= t_l + delta`` that shares a node
  with it, and stops once it holds ``l_max`` edges, once an edge with
  ``t > t_l + delta`` comes first, or at the end of its stream;
* a process is coded by the first-occurrence labels of its nodes, edge by
  edge, as the paper's label string (``(A,B),(B,C),(A,C)`` is "010212");
* the count of a code is the signed sum of the weights of the seeds whose
  processes carry it (weight 1 for a graph; a zone's sign for a zone
  batch, Lemma 4.2's inclusion-exclusion).

Every seed walks at once: each round looks at the next ``block`` slots of
every live process, takes the first it may absorb, or stops it.  This
shares nothing with the program (``repro_torch``), whose scans sweep edge
by edge over zones; it imports torch and numpy only.

A code is kept as one int64 key: digit ``q`` of the label string (label
+ 1, so 0 is padding) sits in 4 bits at shift ``4 * (2 * l_max - 1 -
q)``.  Ascending keys are then the label strings in ascending order.
"""

from __future__ import annotations

import numpy as np
import torch

DIGIT_BITS = 4
#: 2 * l_max digits of 4 bits must fit in the 63 bits of an int64 key
MAX_L_MAX = 7


def _shift(q, l_max: int):
    return DIGIT_BITS * (2 * l_max - 1 - q)


def walk(u, v, t, seeds, ends, *, delta: int, l_max: int, block: int = 64,
         chunk: int = 1 << 17):
    """The process of every seed slot.

    Args:
      u, v, t: int32 or int64 ``[N]`` edge streams on one device; ``t`` is
        non-decreasing from each seed to its end.
      seeds:   int64 ``[S]`` slots that seed a process.
      ends:    int64 ``[S]`` the end (exclusive) of each seed's stream.
    Returns:
      ``(key, steps, node_steps)``, int64 ``[S]`` each: the code key of
      each seed's process; the slots its walk visits: the seed, then every
      slot after it up to and including the one where the walk stops (the
      absorbed ``l_max``-th edge or the first edge past the window), or to
      the end of its stream; and the node tests those slots need: each
      visited slot later than the newest edge and inside its window is
      tested against every node the process holds when it reaches it.
    """
    if not 1 <= l_max <= MAX_L_MAX:
        raise ValueError(f"l_max={l_max} outside 1..{MAX_L_MAX}")
    dev = u.device
    u, v, t = (x.to(torch.int64) for x in (u, v, t))
    n = u.shape[0]
    seeds = seeds.to(torch.int64)
    ends = ends.to(torch.int64)
    keys = torch.zeros_like(seeds)
    steps = torch.zeros_like(seeds)
    node_steps = torch.zeros_like(seeds)
    if n == 0 or seeds.numel() == 0:
        return keys, steps, node_steps
    ar = torch.arange(block, device=dev)
    k_nodes = l_max + 1
    for c0 in range(0, seeds.numel(), chunk):
        s = seeds[c0:c0 + chunk]
        end = ends[c0:c0 + chunk]
        c = s.numel()
        same = u[s] == v[s]
        nodes = torch.full((c, k_nodes), -1, dtype=torch.int64, device=dev)
        nodes[:, 0] = u[s]
        nodes[:, 1] = torch.where(same, -1, v[s])
        n_nodes = 2 - same.to(torch.int64)
        key = (1 << _shift(0, l_max)) | ((1 + (~same).to(torch.int64))
                                         << _shift(1, l_max))
        length = torch.ones(c, dtype=torch.int64, device=dev)
        last_t = t[s].clone()
        cur = s + 1
        step = torch.ones(c, dtype=torch.int64, device=dev)
        node_step = torch.zeros(c, dtype=torch.int64, device=dev)
        live = torch.arange(c, device=dev)
        if l_max == 1:
            live = live[:0]
        while live.numel():
            idx = cur[live, None] + ar
            inb = idx < end[live, None]
            idx = idx.clamp(max=n - 1)
            tt, uu, vv = t[idx], u[idx], v[idx]
            lt = last_t[live, None]
            nod = nodes[live]
            over = inb & (tt > lt + delta)
            touch = ((uu[:, :, None] == nod[:, None, :]).any(2)
                     | (vv[:, :, None] == nod[:, None, :]).any(2))
            elig = inb & (tt > lt) & ~over & touch
            first_elig = torch.where(elig, ar, block).amin(1)
            first_over = torch.where(over, ar, block).amin(1)
            n_in = inb.sum(1)
            absorb = first_elig < block
            timeout = ~absorb & (first_over < block)
            ended = ~absorb & ~timeout & (n_in < block)
            adv = torch.where(absorb, first_elig + 1, torch.where(
                timeout, first_over + 1, torch.where(ended, n_in, block)))
            step[live] += adv
            tested = ((ar < adv[:, None]) & inb & (tt > lt) & ~over).sum(1)
            node_step[live] += tested * n_nodes[live]
            cur[live] += adv
            stop = timeout | ended

            rows = live[absorb]
            if rows.numel():
                e = idx[absorb, first_elig[absorb]]
                ue, ve = u[e], v[e]
                nr = nodes[rows]
                nn = n_nodes[rows]
                hit = nr == ue[:, None]
                u_in = hit.any(1)
                lab_u = torch.where(u_in, hit.to(torch.int8).argmax(1), nn)
                nr = torch.where(~u_in[:, None] & (torch.arange(
                    k_nodes, device=dev) == nn[:, None]), ue[:, None], nr)
                nn = nn + (~u_in).to(torch.int64)
                hit = nr == ve[:, None]
                v_in = hit.any(1)
                lab_v = torch.where(v_in, hit.to(torch.int8).argmax(1), nn)
                nr = torch.where(~v_in[:, None] & (torch.arange(
                    k_nodes, device=dev) == nn[:, None]), ve[:, None], nr)
                nn = nn + (~v_in).to(torch.int64)
                q = 2 * length[rows]
                key[rows] |= (((lab_u + 1) << _shift(q, l_max))
                              | ((lab_v + 1) << _shift(q + 1, l_max)))
                nodes[rows] = nr
                n_nodes[rows] = nn
                length[rows] += 1
                last_t[rows] = t[e]
                full = torch.zeros_like(absorb)
                full[absorb] = length[rows] >= l_max
                stop = stop | full
            live = live[~stop]
        keys[c0:c0 + chunk] = key
        steps[c0:c0 + chunk] = step
        node_steps[c0:c0 + chunk] = node_step
    return keys, steps, node_steps


def count(keys, weights):
    """Signed count per code: ``(sorted unique keys, int64 sums)``."""
    uniq, inv = torch.unique(keys, sorted=True, return_inverse=True)
    sums = torch.zeros(uniq.shape[0], dtype=torch.int64, device=keys.device)
    sums.index_add_(0, inv, weights.to(torch.int64))
    return uniq, sums


def graph_counts(u, v, t, *, delta: int, l_max: int, device="cpu"):
    """The count table of a time-sorted graph: ``(keys, counts, steps,
    node_steps)`` as numpy arrays, the last two per edge (see
    :func:`walk`)."""
    u, v, t = (torch.as_tensor(np.asarray(x), device=device)
               for x in (u, v, t))
    n = u.shape[0]
    seeds = torch.arange(n, device=device)
    ends = torch.full_like(seeds, n)
    key, steps, node_steps = walk(u, v, t, seeds, ends, delta=delta,
                                  l_max=l_max)
    uniq, sums = count(key, torch.ones_like(key))
    return (uniq.cpu().numpy(), sums.cpu().numpy(), steps.cpu().numpy(),
            node_steps.cpu().numpy())


def zone_counts(u, v, t, valid, signs, *, delta: int, l_max: int,
                device="cpu"):
    """The signed count table of a zone batch: each zone row is its own
    stream over its valid prefix, each of its seeds weighs the zone's
    sign.  ``(keys, counts, steps, node_steps)`` as numpy arrays, the last
    two per valid slot in row-major order."""
    valid = np.asarray(valid)
    z, e = valid.shape
    fill = valid.sum(1)
    if not (valid == (np.arange(e)[None, :] < fill[:, None])).all():
        raise ValueError("each zone's valid slots must be a prefix")
    u, v, t = (torch.as_tensor(np.asarray(x).reshape(-1), device=device)
               for x in (u, v, t))
    flat = torch.as_tensor(valid.reshape(-1), device=device)
    seeds = flat.nonzero().flatten()
    zone = seeds // e
    fill_t = torch.as_tensor(fill, device=device, dtype=torch.int64)
    ends = zone * e + fill_t[zone]
    key, steps, node_steps = walk(u, v, t, seeds, ends, delta=delta,
                                  l_max=l_max)
    w = torch.as_tensor(np.asarray(signs), device=device,
                        dtype=torch.int64)[zone]
    uniq, sums = count(key, w)
    return (uniq.cpu().numpy(), sums.cpu().numpy(), steps.cpu().numpy(),
            node_steps.cpu().numpy())


def key_to_string(key: int, l_max: int) -> str:
    """Code key -> the paper's label string (``"010212"``)."""
    out = []
    for q in range(2 * l_max):
        d = (int(key) >> _shift(q, l_max)) & 0xF
        if d == 0:
            break
        out.append(format(d - 1, "x"))
    return "".join(out)


def table_dict(keys, counts, l_max: int) -> dict[str, int]:
    """``{label string: count}`` of a count table, zero counts dropped."""
    return {key_to_string(k, l_max): int(c)
            for k, c in zip(np.asarray(keys).tolist(),
                            np.asarray(counts).tolist()) if c != 0}
