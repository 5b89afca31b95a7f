"""Operations, bytes and the least time of the zone scan B3.

The rule counts what the inputs need, not what a kernel does, so that a
rewritten kernel is read against the same work:

* **Lane-steps.** Each seed's walk from the seed slot to where Definitions
  2-5 stop it: the seed, then every later slot of its zone up to and
  including the absorbed ``l_max``-th edge or the first edge past the
  ``delta`` window, or to the zone's last valid slot.
* **Node tests.** Each slot of a walk that is later than the process's
  newest edge and inside its window is tested against every node the
  process holds when the walk reaches it; the slot past the window and a
  slot at the newest edge's own time need no node test.

:func:`ptmt_bench.reference.ptmt_ref.walk` counts both from the
benchmark's own inputs, not from the program's zone plan or its kernels.

* **Operations**, integer ALU operations only (loads issue on the
  load/store units, not on the INT32 lanes the rate counts):
  per lane-step 4 (test the slot's validity, form the gap to the newest
  edge, test it against 0 and against ``delta``); per node test 4
  (compare ``u`` and ``v`` with the node, keep the first hit of each).
  The absorptions (at most ``l_max - 1`` per seed) are left out.
* **Bytes.** Each input byte once: ``u``, ``v``, ``t`` as int32 per slot
  and the validity mask at one byte per slot; each output byte once: per
  seed one code of ``2 l_max`` 4-bit digits in whole 32-bit words.

The least time is the larger of operations over the integer rate and
bytes over the memory rate, both the NVIDIA H100 SXM's published peaks
(data sheet, at its 700 W limit); no clock read from the card is used.
"""

from __future__ import annotations

#: SMs x INT32 lanes per SM per clock x the published 1.98 GHz boost clock
INT32_OPS_PER_S = 132 * 64 * 1.98e9
#: HBM3, bytes per second
HBM_BYTES_PER_S = 3.35e12
#: integer operations per lane-step and per node test
OPS_PER_LANE_STEP = 4
OPS_PER_NODE_TEST = 4


def code_bytes(l_max: int) -> int:
    """Bytes of one code: ``2 l_max`` digits of 4 bits in 32-bit words."""
    return 4 * -(-(2 * l_max * 4) // 32)


def zone_scan_work(n_slots: int, n_seeds: int, lane_steps: int,
                   node_tests: int, l_max: int) -> dict:
    """B3 on a ``[Z, E]`` zone batch of ``n_slots`` slots, ``n_seeds``
    of them valid."""
    return {"ops": (lane_steps * OPS_PER_LANE_STEP
                    + node_tests * OPS_PER_NODE_TEST),
            "bytes": n_slots * 13 + n_seeds * code_bytes(l_max)}


def bound_s(work: dict) -> float:
    """The least time the card could take for ``work``, in seconds."""
    return max(work["ops"] / INT32_OPS_PER_S,
               work["bytes"] / HBM_BYTES_PER_S)


def is_b3(name: str) -> bool:
    """A profiler activity of the dense kernel B3 (``zone_scan.cu``'s
    ``zone_scan_kernel``), not of the flat kernel B1
    (``fused_zone_scan_kernel``)."""
    return "zone_scan_kernel" in name and "fused_zone_scan" not in name
