#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Drives the port's paths on the card, through the hand-written kernels they
launch, and checks them:

1. device: the card's name and power limit, torch and CUDA versions;
2. build: every CUDA source of the package, with nvcc, all at once, timed,
   with each kernel instantiation's registers and spills;
3. each kernel against its plain PyTorch version on the same CUDA
   tensors, slot for slot (tolerance 0: every output is int32): on the
   power-law bursty corpus, and at full size — the ``email-eu-like``
   generator at the edge count of SNAP's email-Eu-core-temporal, 332,334
   edges, at the paper's defaults delta=600, l_max=6, omega=20 (the flat
   kernel on the 376,832-slot stream, the dense kernel on its largest
   bucket; the dense kernel is timed on every bucket; each kernel with its
   block size, resident blocks and waves, and the per-lane sweep counts
   that the hybrid sweep of both answers: warp use of lanes sweeping
   alone, and the lanes still open after the solo slots); the dense
   kernel also on adversarial rows (``adversarial_rows``) and the flat
   kernel on their flat form (``adversarial_flat``);
4. lossless TZP: ``discover`` on ``backend="cuda"`` equals ``sequential``
   on ``backend="ref"`` (collegemsg-like), and the bursty corpus equals
   the brute-force oracle;
5. the per-bucket paths at full size: ``discover(fused="off")`` in the
   legacy, hierarchical and pipelined agg modes and ``sequential`` on
   ``cuda`` must all equal the fused ``discover``;
6. co-mining at full size: ``discover_many`` over four configs equals four
   independent ``discover`` calls, on the fused path (one ``with_ts``
   launch) and on the per-bucket path (one per bucket);
7. the main path (fused ``discover``) on the full-size graph: one warm-up,
   a traced run for the time breakdown, then three timed runs;
8. the model zoo's kernels against their plain versions on the card: the
   segment scatter-sum (B4) on the JAX tests' shapes in f32 and bf16,
   with a mask, out-of-range ids and a hot segment, every segment split
   into chunks or none, each bitwise the same in two launches, and on a
   hot segment of 8M rows (10M rows into 100,000 segments), timed split
   and unsplit; the embedding bag (B5) on the JAX tests' shapes in f32
   and bf16 and with ids outside the table, and its grouped form (x0 of
   several fields in one launch) on mixed vocabularies and strided views;
   each timed beside its plain version and one PyTorch library call
   (``index_add_``, ``F.embedding_bag``) that is used nowhere else;
9. GNN inference at full width: ``gin-tu``, ``gat-cora`` and ``gatedgcn``
   at their CONFIG widths on ``minibatch_lg`` (169,984 nodes, 168,960
   edges, 602 features, 41 classes; ``random_graph_batch(seed=0)``),
   each forward held against the same forward on the CPU, B4 held
   against its plain version on each model's first real aggregation
   input, timed (ms per forward, edges/s) with 5, 2 and 32 B4 launches
   and one segment plan per forward; B4 on gin-tu's first aggregation
   with the ``h[src]`` gather fused and not (bitwise the same), timed
   beside the plan build, the gather and ``index_add_``; then ``gin-tu``
   on ``ogb_products`` (2,449,029 nodes, 61,859,328 padded edges): the
   same for its first layer, and one forward, which makes no ``[E, D]``
   message tensor, with its peak device memory;
10. DCN-v2 serving at full width (26 tables, 22,875,000 rows x 16, a
    4M x 64 item table, seeded init on the card): ``serve_p99`` (512
    examples) held against the CPU forward, the grouped B5 held against
    its plain version on all 26 fields at ``serve_p99`` and
    ``serve_bulk`` (262,144 examples, bag 4) and timed beside the
    single-field B5 (F = 1) on each field alone, 26 of its launches writing
    x0 in place in one graph, and 26 ``F.embedding_bag`` calls plus a
    concat, ``serve_bulk`` timed (ms per forward, examples/s), and
    ``retrieval_cand`` (1 query, 1,000,000 candidates, top 100) held
    against the CPU; one B5 launch per forward; B5 and its library calls
    are timed by replaying a CUDA graph of 20 calls (device time, without
    the wrappers' host time, which a call at ``serve_p99`` exceeds);
11. streaming at full size: ``engine.stream()`` fed by ``replay_stream`` in
    4,096-edge chunks; the snapshots at 25%, 50% and 75% of the stream
    equal ``discover`` on their closed prefixes and the final one the
    fused ``discover``; the same replay with ``fused="off"`` (B3) gives the
    same counts; a ``state_dict`` taken at 50% and restored into a fresh
    miner ends at the same counts (its replay profiled for the card's
    busy share); ingest edges/s, per-chunk p50/p99/max, zones finalized,
    and a cold snapshot split into mine and decode;
12. serving at full size: ``serve_motifs``'s single-service workload (4
    tenants strided from the graph, 2,048-edge chunks, admission batch
    8,192, 4 queries per chunk in its fixed mix), its ``--verify`` check,
    ``comine`` over ``{600, 300} x {6, 4}`` against phase 6's four
    ``discover`` calls (one B1-ts launch), one tenant's first query of an
    epoch mining beside another tenant's ingest in two threads, then
    cluster mode: 2 workers with a temporary checkpoint directory, the
    owner of ``tenant0`` killed after half of each stream, its tenants
    restored from their checkpoints on the survivor, the streams finished
    (counts equal to the single service's), and a cold restart from the
    store (the same counts again);
13. sharded mining at full size: ``engine.sharded`` on a one-rank NCCL
    ``DeviceMesh`` in this process, then on four gloo ranks spawned on
    ``cuda:0`` as a ``(2, 2)`` mesh (NCCL takes one rank per card), both
    merge modes, each result equal to the fused ``discover`` byte for
    byte, with B3 launches counted per rank and each run timed;
14. training at full width: B4's backward (the same kernel on the
    transposed plan) held against its plain version at gin-tu's
    ``minibatch_lg`` shapes and ``embedding_bag_fields_backward`` at
    ``train_batch`` (65,536 x 26 fields x bag 4), each timed beside its
    plain version and ``index_add_``; gin-tu, gat-cora and gatedgcn on
    ``minibatch_lg``: the first step's loss against the CPU's (rtol 1e-4)
    and each gradient leaf's difference from the CPU's (its norm at most
    1e-2 of the gradient's, see ``TRAIN_FROB``), then 5 AdamW
    steps through ``train_loop.run`` with a checkpoint and a resume, ms
    per step; DCN-v2 at CONFIG: a step's gradients against the CPU's at
    512 examples (every table gets one), then ``train_batch`` steps timed
    and profiled;
15. one JSON line naming every kernel with its launches, error and times;
16. last line: ``{"ok": true, "device": {...}}``.

Every path of phases 5-7 and 9-14 (but for phase 12's threaded check)
runs with the kernels' launch counts
set to 0 just before it and read just after; a kernel its path should
launch but did not (or, where a count is set, launched another number of
times) fails the run.  Matmuls run in full float32: TF32 is switched off
for cuBLAS and cuDNN before anything runs.  The script exits non-zero,
with no result line, when any phase fails or when PyTorch sees no CUDA
device.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

# full-size configuration: SNAP email-Eu-core-temporal's edge count on the
# repo's email-eu-like generator, at the paper's default parameters
FULL_EDGES = 332_334
FULL_NODES = 986
FULL_PARAMS = dict(delta=600, l_max=6, omega=20)
# co-mined lattice at full size: {600, 300} x {6, 4}, omega 20
COMINE = [(d, lm) for d in (600, 300) for lm in (6, 4)]
TIMED_RUNS = 3
KERNEL_REPS = 20
# slots a lane of either zone-scan kernel sweeps alone (kSoloSlots,
# edge_update.cuh)
SOLO_SLOTS = 32
DEVICE = "cuda"
# per visited slot the flat kernel loads zone_id, valid, t, u, v (5), tests
# the zone and the validity (2), forms the gap and its two tests (3), and
# for each of the K = l_max + 1 node slots compares u and v and keeps the
# first hit of each (4 per slot); extensions (at most l_max per lane) are
# left out.  The dense kernel has no zone to load or test (8 fixed).
OPS_FIXED, OPS_FIXED_DENSE, OPS_PER_NODE = 10, 8, 4
SRC = "src/repro_torch/kernels/zone_scan/csrc/"
TPU = "src/repro/kernels/zone_scan/zone_scan.py"
VARIANT_FLAT = {False: "fused_zone_scan_flat",
                True: "fused_zone_scan_flat_ts"}
VARIANT_DENSE = {False: "zone_scan_dense", True: "zone_scan_dense_ts"}

# An H100 SXM's published peaks at its 700 W limit (NVIDIA's data sheet):
# the HBM3 rate every byte bound divides by, and the float32 rate outside
# the tensor cores (model zoo, phases 8-10)
HBM_RATE = 3.35e12
FP32_RATE = 67e12
SPMM_SRC = "src/repro_torch/kernels/segment_spmm/csrc/segment_spmm.cu"
SPMM_TPU = "src/repro/kernels/segment_spmm/segment_spmm.py:57"
BAG_SRC = "src/repro_torch/kernels/embedding_bag/csrc/embedding_bag.cu"
BAG_TPU = "src/repro/kernels/embedding_bag/embedding_bag.py:38"
# (E, N, D) and (V, D, B, K) of the JAX package's kernel tests
SPMM_SHAPES = ((100, 40, 8), (1000, 128, 64), (513, 300, 70), (2048, 64, 128))
BAG_SHAPES = ((1000, 16, 64, 4), (5000, 64, 100, 1), (300, 128, 257, 8))
# (rtol, atol) of the JAX kernel tests, against an fp32 plain version: the
# rows are summed in another order (and multiplied-added in one rounding);
# bf16 also rounds the inputs and each stored sum
TOL_SPMM = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 0.15)}
TOL_BAG = {"float32": (1e-5, 1e-5), "bfloat16": (5e-2, 5e-2)}
# GNN archs at their CONFIG widths and their B4 launches per forward
GNN_MODELS = (("gin-tu", 5), ("gat-cora", 2), ("gatedgcn", 32))
# a card forward against the CPU forward: rtol, and an atol of this times
# the output's largest magnitude (matmuls and sums run in another order)
GNN_TOL, DCN_TOL = 1e-4, 1e-5
TOP_K = 100
# B4's hot segment at size: rows, segments, width (80% of rows in one)
HOT_SEGMENT = (10_000_000, 100_000, 64)
# streaming and serving at full size (phases 11-12): the stream's chunk;
# tenants strided from the graph, their arrival chunk, admission batch and
# queries per chunk (``serve_motifs``'s defaults)
STREAM_CHUNK = 4096
SERVE_TENANTS, SERVE_CHUNK, SERVE_BATCH, SERVE_QUERIES = 4, 2048, 8192, 4
# sharded mining (phase 13): gloo ranks spawned on one card, their mesh,
# and the rows each rank folds its zones into and sends to the merge: the
# full size has 114,124 codes, more than the default out_cap of 65,536,
# and a rank's own table (one zone of the largest bucket: 72,464 rows)
# cannot hold two ranks' merged codes in the hierarchical merge; either
# overflow raises, as in the JAX package, so each rank folds into a
# bounded carry of this many rows (agg="hierarchical", merge_cap) and
# sends up to as many (out_cap)
SHARD_RANKS, SHARD_MESH, SHARD_AXES = 4, (2, 2), ("a", "b")
SHARD_CAP = 1 << 19
# training (phase 14): a step on the card against the same step on the
# CPU.  The loss: rtol TRAIN_TOL.  Each gradient leaf: the norm of the
# difference over the norm of the CPU's, at most TRAIN_FROB.  Not
# elementwise: at full width a few ReLU (and leaky-ReLU) inputs lie
# within rounding of 0 and switch sides between the two runs, and each
# such unit moves the gradient rows it feeds; the CPU's own float32 run
# differs from a float64 one in the same way (logged beside it).  A lost
# gradient term is an error of order 1.
TRAIN_TOL, TRAIN_FROB = 1e-4, 1e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def powerlaw_bursty(seed, n=220, nodes=9):
    """Power-law burst sizes + quiet gaps: zone sizes span several
    power-of-two buckets."""
    from repro_torch.core.temporal_graph import from_edges

    rng = np.random.default_rng(seed)
    us, vs, ts = [], [], []
    now = 0
    while len(ts) < n:
        burst = min(int(rng.pareto(0.9) * 3) + 1, 70)
        group = rng.integers(0, nodes, size=max(2, burst // 4 + 2))
        for _ in range(burst):
            a, b = rng.choice(group, 2, replace=True)
            us.append(a)
            vs.append(b)
            ts.append(now + int(rng.integers(0, 30)))
        now += int(rng.integers(150, 700))
    return from_edges(np.asarray(us[:n]), np.asarray(vs[:n]),
                      np.asarray(ts[:n]))


def adversarial_rows(w: int, e_cap: int = 2600, seed: int = 3):
    """A ``[Z, E]`` zone batch that probes the dense kernel's hybrid sweep
    (each lane alone for ``w`` slots, then its warp 32 slots per step), at
    ``delta=1000``; ``E`` is no multiple of 32, so warps straddle rows.

    Row 0: lane 0 crosses E - 200 slots within delta with no event (the
    fillers' nodes are all new), then extends, meets a tie, an earlier
    time and an invalid would-be event, extends again and times out; every
    filler lane crosses the row too; after the time-out an edge would
    extend lane 0 were it alive.  Rows 1 and 2: extensions exactly at
    the last solo slot ``w``, the first cooperative slot, a 32-slot chunk
    boundary and the last slot of a chunk, then a full lane with events
    after it; row 2 seeds at slot 5, so its lanes sit elsewhere in their
    warps.  Row 3: ties and invalid would-be events inside and after the
    solo slots, an invalid would-be time-out, a real time-out and an edge
    that would extend the lane were it alive.  Row
    4: an unsorted row (random times over six nodes, 80% valid).  Row 5: a
    sorted bursty row over eight nodes.
    """
    from types import SimpleNamespace

    rng = np.random.default_rng(seed)
    z = 6
    u = np.zeros((z, e_cap), np.int64)
    v = np.zeros((z, e_cap), np.int64)
    t = np.zeros((z, e_cap), np.int64)
    valid = np.ones((z, e_cap), bool)
    fresh = iter(range(1000, 1000 + 2 * z * e_cap))
    for r in range(4):                 # fillers: new nodes, small times
        for j in range(e_cap):
            u[r, j], v[r, j] = next(fresh), next(fresh)
            t[r, j] = j // 8

    def put(r, j, a, b, when, ok=True):
        u[r, j], v[r, j], t[r, j], valid[r, j] = a, b, when, ok

    quiet = e_cap - 200
    put(0, 0, 0, 1, 0)
    put(0, quiet, 1, 2, quiet // 8 + 1)                   # extension
    put(0, quiet + 1, 5, 2, quiet // 8 + 1)               # tie: no event
    put(0, quiet + 2, 2, 7, quiet // 8)                   # earlier time
    put(0, quiet + 3, 2, 8, quiet // 8 + 9, ok=False)     # invalid
    put(0, quiet + 4, 2, 9, quiet // 8 + 10)              # extension
    t[0, quiet + 5:] = quiet // 8 + 10 + 1001              # time-outs
    put(0, quiet + 6, 1, 3, quiet // 8 + 20)     # an event, were it alive
    for r, s0 in ((1, 0), (2, 5)):
        put(r, s0, 0, 1, s0 // 8)
        first = s0 + w + 1                 # first slot of the warp phase
        marks = [s0 + w, first, first + 1 + 32, first + 1 + 32 + 1 + 31,
                 first + 1 + 32 + 1 + 31 + 1 + 96, first + 400]
        node = 1
        for j in marks:                    # a chain: each touches the last
            put(r, j, node, 10 + node, j)
            node = 10 + node
    put(3, 0, 0, 1, 100)
    for j in (3, 20, w, w + 1):
        put(3, j, 1, 50 + j, 100)                         # ties
    for j in (10, w + 2, w + 33):
        put(3, j, 1, 60 + j, 150, ok=False)               # invalid events
    put(3, 70, 1, 2, 150)                                 # extension
    t[3, 71:] = 150
    put(3, 75, 2, 3, 150)                                 # tie
    put(3, 90, 70, 71, 5000, ok=False)                    # invalid time-out
    put(3, 200, 70, 71, 1151)                             # time-out
    t[3, 201:] = 1151
    put(3, 201, 2, 4, 160)                       # an event, were it alive
    u[4] = rng.integers(0, 6, e_cap)
    v[4] = rng.integers(0, 6, e_cap)
    t[4] = rng.integers(0, 20_000, e_cap)
    valid[4] = rng.random(e_cap) < 0.8
    u[5] = rng.integers(0, 8, e_cap)
    v[5] = rng.integers(0, 8, e_cap)
    t[5] = np.cumsum(rng.integers(0, 40, e_cap))
    return SimpleNamespace(u=u.astype(np.int32), v=v.astype(np.int32),
                           t=t.astype(np.int32), valid=valid)


def adversarial_flat(w: int, e_cap: int = 2600, blk: int = 512,
                     seed: int = 5):
    """A flat slot stream that probes the flat kernel's row ends under its
    hybrid sweep (each lane alone for ``w`` slots, then its warp 32 slots
    per step), at ``delta=1000``.  Zones, laid end to end in this order:

    * each of the six rows of ``adversarial_rows(w, e_cap)`` (``E`` no
      multiple of 32, so each ends inside a warp), then four short zones
      of 1 to 40 slots (several zones per warp) over six nodes, at times
      that run on from the row's last slot: the first edge of every zone
      would extend the open lanes of the zone before it;
    * after rows 1 and 4, zones of ``w``, ``w + 1`` and ``w + 2`` slots
      seeded on their first slot, each followed by such a short zone: the
      first lane meets its zone's end on the last solo slot, the first
      cooperative slot and the one after (fillers on new nodes keep it
      open), and so do the fillers' lanes at other offsets;
    * the last zone ends inside a warp, on the stream pad (``zone_id``
      -1, ``valid`` 0).

    ``hi`` of each block is the ``blk``-aligned end of the last zone its
    lanes belong to (``bounds="full"``), except in the block in the middle
    of row 5 (sorted, bursty: its lanes extend across the cut), whose
    ``hi`` is its own end.  Returns the fields of a flat layout that
    :func:`check_flat` reads.
    """
    from types import SimpleNamespace

    rng = np.random.default_rng(seed)
    rows = adversarial_rows(w, e_cap)
    zones = []
    fresh = iter(range(50_000, 10_000_000))

    def short_zones(t0, n):
        for _ in range(n):
            size = int(rng.integers(1, 41))
            u = rng.integers(0, 6, size)
            v = rng.integers(0, 6, size)
            u[0], v[0] = 1, 2
            t = t0 + 1 + np.cumsum(rng.integers(0, 4, size))
            ok = rng.random(size) < 0.85
            ok[0] = True
            zones.append((u, v, t, ok))
            t0 = int(t[-1])
        return t0

    for r in range(6):
        zones.append((rows.u[r], rows.v[r], rows.t[r], rows.valid[r]))
        if r == 5:
            row5 = len(zones) - 1
        t0 = short_zones(int(rows.t[r][-1]), 4)
        if r in (1, 4):
            for size in (w, w + 1, w + 2):
                u = np.asarray([next(fresh) for _ in range(size)])
                v = np.asarray([next(fresh) for _ in range(size)])
                u[0], v[0] = 0, 1
                t = t0 + 1 + np.arange(size) // 4
                zones.append((u, v, t, np.ones(size, bool)))
                t0 = short_zones(int(t[-1]), 1)
    n = sum(z[0].size for z in zones)
    if n % 32 == 0:                        # end the stream inside a warp
        u, v, t, ok = zones[-1]
        zones[-1] = (np.append(u, 3), np.append(v, 4), np.append(t, t[-1]),
                     np.append(ok, True))
        n += 1
    s_pad = -(-n // blk) * blk
    cat = lambda i, fill: np.concatenate(
        [z[i] for z in zones] + [np.full(s_pad - n, fill)])
    zone_id = np.concatenate(
        [np.full(z[0].size, i) for i, z in enumerate(zones)]
        + [np.full(s_pad - n, -1)]).astype(np.int32)
    ends = np.cumsum([z[0].size for z in zones])
    n_blocks = s_pad // blk
    lo = np.arange(n_blocks, dtype=np.int32) * blk
    hi = lo.copy()
    for i in range(n_blocks):
        last = zone_id[min((i + 1) * blk, n) - 1] if i * blk < n else -1
        if last >= 0:
            hi[i] = -(-ends[last] // blk) * blk
    start5 = ends[row5] - zones[row5][0].size
    cut = (start5 + e_cap // 2) // blk
    hi[cut] = (cut + 1) * blk
    valid = cat(3, False).astype(bool)
    return SimpleNamespace(
        u=cat(0, 0).astype(np.int32), v=cat(1, 0).astype(np.int32),
        t=cat(2, 0).astype(np.int32), valid=valid.astype(np.int32),
        zone_id=zone_id, lo=lo, hi=hi, blk=blk, n_slots=s_pad,
        n_blocks=n_blocks, valid_edges=int(valid.sum()),
        bounds=f"full, block {cut} cut at its end")


def cuda_ms(fn, reps: int = 1) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls (CUDA events)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = KERNEL_REPS) -> float:
    """Device time of one ``fn()`` with the host left out: ``reps`` calls
    captured in one CUDA graph, the graph replayed and timed with CUDA
    events (for a kernel whose wrapper takes longer on the host than the
    kernel on the card, where ``cuda_ms`` times the host)."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    ms = cuda_ms(graph.replay, 3) / reps
    del graph
    return ms


def flat_tensors(fl, device):
    import torch

    return [torch.as_tensor(x, device=device) for x in (
        fl.u, fl.v, fl.t, fl.valid, fl.zone_id, fl.lo, fl.hi)]


def batch_tensors(b, device):
    import torch

    return [torch.as_tensor(x, device=device) for x in (b.u, b.v, b.t)] \
        + [torch.as_tensor(b.valid, device=device).to(torch.int32)]


def max_err(outs, plains) -> int:
    return max(int((a - b).abs().max()) if a.numel() else 0
               for a, b in zip(outs, plains))


def copy_bandwidth() -> float:
    """Device-to-device copy rate in bytes/s (read + write counted)."""
    import torch

    n = 1 << 28                                     # 1 GiB of int32
    a = torch.empty(n, dtype=torch.int32, device=DEVICE).fill_(1)
    b = torch.empty_like(a)
    b.copy_(a)
    ms = cuda_ms(lambda: b.copy_(a), reps=10)
    del a, b
    return 2 * 4 * n / (ms * 1e-3)


def demangle(names) -> dict:
    """Readable kernel names, by the toolkit's ``cu++filt`` (else
    ``c++filt``, else as they are)."""
    from repro_torch.kernels import _build

    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cu++filt")
    if not os.path.exists(tool):
        tool = shutil.which("c++filt")
    if tool is None or not names:
        return {n: n for n in names}
    out = subprocess.run([tool], input="\n".join(names), check=True,
                         capture_output=True, text=True, timeout=60)
    return dict(zip(names, out.stdout.splitlines()))


def report_registers(logs: dict) -> None:
    """Registers of every entry function, from ``ptxas -v``: the zone-scan
    instantiations by ``l_max`` and variant, every other kernel by name
    (the range over its template instantiations); and the entry functions
    that spill, with their spill bytes."""
    spills, others = [], {}
    by_lmax: dict[str, list] = {}
    for src, text in logs.items():
        # one block per entry function, whatever order ptxas reports in
        for block in text.split("Compiling entry function '")[1:]:
            name = block.split("'", 1)[0]
            regs = re.search(r"Used (\d+) registers", block)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                              r"spill loads", block)
            if not (regs and spill):
                log(f"[build] {src}: no register report read for {name}")
                continue
            inst = re.search(r"ILi(\d+)ELb([01])E", name)
            if int(spill.group(1)) or int(spill.group(2)):
                spills.append((src, name, inst, spill.group(1),
                               spill.group(2)))
            if inst:        # the zone-scan template <l_max, with_ts>
                by_lmax.setdefault(src, []).append(
                    (int(inst.group(1)), int(inst.group(2)),
                     int(regs.group(1))))
            else:
                others.setdefault((src, name), int(regs.group(1)))
    for src, rows in by_lmax.items():
        rows.sort()
        for ts in (0, 1):
            log(f"[build] {src} with_ts={ts}: registers by l_max "
                + ", ".join(f"{lm}:{r}" for lm, t, r in rows if t == ts))
    names = demangle([name for _, name in others])

    def short_name(name):     # "kernel<args>" without namespace or params
        full = names.get(name, name)
        full = full[:full.find(">(") + 1] if ">(" in full else full
        return full.split("::")[-1] if "::" in full else full

    kernels: dict[tuple, list] = {}
    for (src, name), r in others.items():
        base = short_name(name).split("<")[0].split("(")[0]
        kernels.setdefault((src, base), []).append((short_name(name), r))
    for (src, base), insts in kernels.items():
        regs = [r for _, r in insts]
        # each instantiation of a kernel that has few of them
        each = ("" if len(insts) > 8 else " (" + "; ".join(
            f"{n[len(base):]} {r}" for n, r in insts) + ")")
        log(f"[build] {src} {base}: {min(regs)}-{max(regs)} registers over "
            f"{len(regs)} instantiation(s){each}")
    short = []
    for src, name, inst, st, ld in spills:
        label = (f"l_max={inst.group(1)} ts={inst.group(2)}" if inst
                 else short_name(name))
        short.append(f"{src} {label} ({st}/{ld} bytes stored/loaded)")
    log(f"[build] spills: {'; '.join(short) if short else 'none'}")


def check_flat(name, fl, *, delta, l_max, with_ts):
    """Flat kernel vs its plain version on one layout; returns the kernel's
    outputs, the tensors, and the error."""
    import torch
    from repro_torch.kernels.zone_scan import ops, ref

    args = flat_tensors(fl, DEVICE)
    out = ops.launch_kernel(*args, delta=delta, l_max=l_max, blk=fl.blk,
                            with_ts=with_ts)
    torch.cuda.synchronize()
    plain = ref.fused_zone_scan_torch(*args, delta=delta, l_max=l_max,
                                      blk=fl.blk, with_ts=with_ts)
    err = max_err(out, plain)
    log(f"  {name}: with_ts={with_ts} S={fl.n_slots} valid="
        f"{fl.valid_edges} bounds={fl.bounds} max_abs_err={err}")
    if err:
        raise SystemExit(f"flat kernel != plain version on {name}")
    return args, out, err


def check_dense(name, b, *, delta, l_max):
    """Dense kernel, both variants, vs the plain expansion on one bucket.

    One plain run with ``with_ts`` is the reference of both variants: its
    code and length are the plain ``with_ts=False`` outputs (the CPU tests
    hold that), and its ts is the variant's third output.
    """
    import torch
    from repro_torch.core import expansion
    from repro_torch.kernels.zone_scan import ops

    args = batch_tensors(b, DEVICE)
    out = ops.launch_zone_kernel(*args, delta=delta, l_max=l_max)
    out_ts = ops.launch_zone_kernel(*args, delta=delta, l_max=l_max,
                                    with_ts=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = expansion.scan_zones(*args, delta=delta, l_max=l_max,
                                 with_ts=True)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    err = max_err(out[:2], plain[:2])
    err_ts = max_err(out_ts, plain)
    log(f"  {name}: [Z, E]={tuple(b.u.shape)} valid={int(b.valid.sum())} "
        f"max_abs_err={err} (with_ts: {err_ts}), plain {plain_s:.1f}s")
    if err or err_ts:
        raise SystemExit(f"dense kernel != plain version on {name}")
    return args, plain_s, max(err, err_ts)


def dense_lane_steps(args, *, delta, l_max):
    """Slots each lane of one ``[Z, E]`` batch visits in the sequential
    sweep, its seed included (``int64[Z * E]`` in the kernel's lane order,
    0 for an invalid slot): the flat sweep's count on the same rows laid
    end to end, one block per row (the kernels' sweeps stop where the
    sequential sweep stops)."""
    import torch
    from repro_torch.kernels.zone_scan import ref

    z, e = args[0].shape
    rows = torch.arange(z, dtype=torch.int32, device=DEVICE)
    zone_id = rows.repeat_interleave(e)
    return ref.lane_steps(
        *(x.reshape(-1) for x in args), zone_id, rows * e, (rows + 1) * e,
        delta=delta, l_max=l_max, blk=e)


def sweep_counts(label, steps) -> None:
    """Logs how a warp of lanes that each sweep alone would use its
    lane-steps on one batch or flat stream, and what the zone-scan
    kernels' hybrid sweep leaves at W = 16 and at their W = SOLO_SLOTS
    solo slots: lanes still open after W, the warp-steps of the capped
    solo phase, and the 32-slot steps the open lanes' remaining slots need
    (each event the warp applies adds at most one more).  Counts, not
    times."""
    import torch

    after = (steps - 1).clamp(min=0)              # slots after the seed
    pad = -after.numel() % 32
    warps = torch.cat([after, after.new_zeros(pad)]).view(-1, 32)
    longest = int(warps.max(1).values.sum())
    busy = int(after.sum())
    q = torch.quantile(after[after > 0].double(), torch.tensor(
        [0.5, 0.99], dtype=torch.float64, device=after.device)).tolist() \
        if busy else [0.0, 0.0]
    hybrid = []
    for w in (16, SOLO_SLOTS):
        solo = int(warps.clamp(max=w).max(1).values.sum())
        left = (after - w).clamp(min=0)
        chunks = int(((left + 31) // 32).sum())
        hybrid.append(f"W={w}: {solo} solo warp-steps, {int((left > 0).sum())}"
                      f" lanes open after W, their {int(left.sum())} slots in"
                      f" >= {chunks} 32-slot steps, >= {solo + chunks} "
                      "warp-steps in all")
    log(f"  sweep counts {label}: {after.numel()} lanes, {busy} slots "
        f"visited after the seed (mean {busy / max(1, after.numel()):.1f}, "
        f"median {q[0]:.0f}, p99 {q[1]:.0f}, max {int(after.max())} of a "
        f"visiting lane); lanes sweeping alone: {longest} warp-steps, "
        f"{busy / max(1, 32 * longest):.1%} of their lane-steps busy; "
        "hybrid " + "; ".join(hybrid))


def flat_span_ms(args, layout, *, delta, l_max, blk) -> list:
    """The flat kernel timed on the blocks of each bucket's rows in the
    flat stream (``concat_layout``'s order; a block shared by two buckets
    runs in both), ``hi`` rebased and cut at the span's end: where its
    time goes.  Returns ``[(bucket label, slots, ms)]``."""
    import torch
    from repro_torch.kernels.zone_scan import ops

    out, pos = [], 0
    for b in layout.buckets:
        n = int((b.perm >= 0).sum()) * b.e_cap
        first, end = pos // blk, -(-(pos + n) // blk)
        pos += n
        sub = [x[first * blk:end * blk] for x in args[:5]]
        lo = torch.arange(end - first, dtype=torch.int32,
                          device=args[0].device) * blk
        hi = torch.maximum((args[6][first:end] - first * blk).clamp(
            max=(end - first) * blk), lo)
        run = lambda: ops.launch_kernel(*sub, lo, hi, delta=delta,
                                        l_max=l_max, blk=blk)
        run()       # the outputs' first allocation stays out of the time
        out.append((b.label, (end - first) * blk, cuda_ms(run, KERNEL_REPS)))
    return out


def kernel_ops():
    """The wrapper module of every kernel source, each with its launch
    counts."""
    from repro_torch.kernels.embedding_bag import ops as bag_ops
    from repro_torch.kernels.segment_spmm import ops as spmm_ops
    from repro_torch.kernels.zone_scan import ops as scan_ops

    return scan_ops, spmm_ops, bag_ops


def profiled(tag, label, fn, top_n: int = 6) -> None:
    """One call of ``fn`` under ``torch.profiler``: its wall time, the
    device's busy and idle shares, and the kernels that took the most
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device activities only (kernels, memsets, copies); the operators
    # that launched them carry the same time again as their children
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms = e.time_range.elapsed_us() / 1e3
            by_name[e.name] = by_name.get(e.name, 0.0) + ms
    busy_ms = sum(by_name.values())
    if busy_ms > 0:
        top = sorted(by_name.items(), key=lambda r: -r[1])[:top_n]
        log(f"[{tag}] profiled {label}: wall {wall_ms:.3f} ms, device "
            f"busy {busy_ms:.3f} ms ({busy_ms / wall_ms:.1%}), idle "
            f"{1 - busy_ms / wall_ms:.1%}; top device time: " + "; ".join(
                f"{k[:60]} {ms:.3f} ms" for k, ms in top))
    else:
        log(f"[{tag}] profiler recorded no device time for {label}: busy "
            "share not measured")


def run_counted(label, fn, expect):
    """Run one path with every launch count (and B4's count of segment
    plans) at 0 before and read after; fails when a kernel in ``expect``
    ran no launch (or, where ``expect`` gives a number, another number of
    launches)."""
    import torch

    modules = kernel_ops()
    for ops in modules:
        ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = {k: v for ops in modules
              for k, v in (*ops.launches.items(),
                           *getattr(ops, "plans", {}).items())}
    for name, n in expect.items():
        if counts[name] == 0 or (n is not None and counts[name] != n):
            raise SystemExit(f"{label}: {name} launched {counts[name]} "
                             f"time(s), expected {n or 'some'}")
    log(f"[{label}] {dt:.3f}s, launches "
        + ", ".join(f"{k} {v}" for k, v in counts.items() if v))
    return res, dt, counts


# -- model zoo (phases 8-10) ---------------------------------------------

def hold(label, got, want, rtol, atol) -> float:
    """Fails unless ``got`` equals ``want`` within ``atol + rtol * |want|``
    elementwise (NaN where both are NaN); returns the largest absolute
    error."""
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise SystemExit(f"{label}: shape {tuple(got.shape)} != "
                         f"{tuple(want.shape)}")
    same = (got == want) | (got.isnan() & want.isnan())
    diff = (got - want).abs()
    ok = same | (diff <= atol + rtol * want.abs())
    err = float(diff[~same].max()) if bool((~same).any()) else 0.0
    if not bool(ok.all()):
        raise SystemExit(f"{label}: outside its tolerance, max abs err "
                         f"{err} (rtol {rtol}, atol {atol})")
    return err


def scaled_tol(want, tol):
    """(rtol, atol) for a whole forward: atol scales with the output."""
    return tol, tol * max(1.0, float(want.abs().max()))


def tree_to(tree, device):
    return {k: tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def timed_runs_of(fn, runs: int = TIMED_RUNS):
    """``(last output, [seconds per run])`` of ``runs`` synced calls."""
    import torch

    out, times = None, []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return out, times


def record_calls(owner, name: str, run) -> list:
    """The arguments of every call to ``owner.<name>`` while ``run()``
    runs (the attribute is restored after)."""
    calls, orig = [], getattr(owner, name)

    def tap(*args, **kwargs):
        calls.append(args)
        return orig(*args, **kwargs)

    setattr(owner, name, tap)
    try:
        run()
    finally:
        setattr(owner, name, orig)
    return calls


def check_spmm_shapes() -> float:
    """B4 against its plain version on the JAX tests' cases; returns the
    largest f32 error."""
    import torch
    from repro_torch.kernels.segment_spmm import ops, ref

    cases = [(f"E,N,D={e},{n},{d}", e, n, d, seed, None, None)
             for seed, (e, n, d) in ((e + n + d, (e, n, d))
                                     for e, n, d in SPMM_SHAPES)]
    cases += [("mask", 500, 100, 32, 7, "mask", None),
              ("ids out of range, a NaN row", 600, 50, 24, 12, "range",
               None),
              # ~640 rows summed into one segment: the JAX test's 1e-4 (f32)
              ("hot segment", 800, 256, 16, 9, "hot", (1e-4, 1e-4))]
    errs = {"float32": 0.0, "bfloat16": 0.0}
    for label, e, n, d, seed, kind, tol in cases:
        rng = np.random.default_rng(seed)
        values = rng.standard_normal((e, d)).astype(np.float32)
        seg = rng.integers(0, n, e)
        mask = None
        if kind == "mask":
            mask = torch.as_tensor(rng.random(e) < 0.7, device=DEVICE)
        elif kind == "range":
            seg = rng.integers(-60, n + 60, e)
            values[5] = np.nan
        elif kind == "hot":
            seg = np.where(rng.random(e) < 0.8, 3, seg)
        seg = torch.as_tensor(seg.astype(np.int32), device=DEVICE)
        for dt in errs:
            v = torch.as_tensor(values, device=DEVICE).to(getattr(torch, dt))
            got = ops.scatter_sum(v, seg, n, mask)
            plan = ops.plan(seg, n, mask)
            # every segment split into chunks of 1 and 7 rows, or none
            outs = [ops.launch_kernel(v, plan, plan.order, chunk=c)
                    for c in (1, 7, e)]
            torch.cuda.synchronize()
            if not torch.equal(got, ops.scatter_sum(v, seg, n, mask)):
                raise SystemExit(f"segment_spmm {label} {dt}: two launches "
                                 "differ")
            want = ref.scatter_sum(v.float(), seg, n, mask)
            rtol, atol = tol if tol and dt == "float32" else TOL_SPMM[dt]
            for c, out in zip(("default", 1, 7, e), [got, *outs]):
                err = hold(f"segment_spmm {label} {dt} chunk {c}", out, want,
                           rtol, atol)
                errs[dt] = max(errs[dt], err)
    log(f"[kernel-vs-plain] segment_spmm on {len(cases)} cases x f32/bf16 x "
        f"chunks {ops.CHUNK_ROWS}, 1, 7 and unsplit, each bitwise the same "
        f"in two launches: max abs err f32 {errs['float32']}, bf16 "
        f"{errs['bfloat16']} (tolerances {TOL_SPMM})")
    return errs["float32"]


def spmm_hot_segment(bound) -> float:
    """B4 on a hot segment at a large size: 10M rows of 64 f32 (N(0, 1)
    from a seed) into 100,000 segments, 80% of them into segment 3.
    Held against the plain version accumulated in float64 (the fp32 plain
    version rounds each of 8M adds of a running sum of ~10^3, and its
    atomic order differs per run), at TOL_SPMM's rtol and an atol of
    TOL_SPMM's 1e-5 times the largest |sum|, as a whole forward is held;
    bitwise the same in two launches; timed split (chunks of CHUNK_ROWS
    rows, each on its own warp, and a combine of their fp32 sums) and
    unsplit (the hot segment on one warp).  Returns the error."""
    import torch
    from repro_torch.kernels.segment_spmm import ops, ref

    (e, n, d), hot = HOT_SEGMENT, 3
    gen = torch.Generator(device=DEVICE).manual_seed(17)
    values = torch.randn((e, d), generator=gen, device=DEVICE)
    seg = torch.randint(0, n, (e,), generator=gen, device=DEVICE,
                        dtype=torch.int32)
    seg = torch.where(torch.rand(e, generator=gen, device=DEVICE) < 0.8,
                      hot, seg)
    plan = ops.plan(seg, n)
    got = ops.segment_sum(values, plan)
    again = ops.segment_sum(values, plan)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise SystemExit("segment_spmm hot segment: two launches differ")
    want = ref.scatter_sum(values, seg, n, acc_dtype=torch.float64)
    rtol, atol = TOL_SPMM["float32"]
    err = hold("segment_spmm hot segment vs plain in float64", got, want,
               rtol, atol * float(want.abs().max()))
    plain32 = ref.scatter_sum(values, seg, n)
    err32 = float((plain32 - want).abs().max())
    split_ms = cuda_ms(lambda: ops.launch_kernel(values, plan, plan.order),
                       5)
    # the chunk size: the longest segment one lane group sums alone, and
    # the partial rows the combine reads serially
    by_chunk = {c: cuda_ms(lambda: ops.launch_kernel(
        values, plan, plan.order, chunk=c), 3) for c in (256, 4096)}
    whole_ms = cuda_ms(lambda: ops.launch_kernel(values, plan, plan.order,
                                                 chunk=e))
    lib = lambda: torch.zeros((n, d), device=DEVICE).index_add_(0, seg,
                                                                values)
    lib()
    lib_ms = cuda_ms(lib, 5)
    rows = int((seg == hot).sum())
    log(f"[kernel-vs-plain] segment_spmm hot segment: {e} x {d} f32 into "
        f"{n} segments, {rows} rows in one; == plain in float64 (max abs "
        f"err {err}; the fp32 plain version's own is {err32}); split "
        f"{split_ms:.4f} ms, unsplit {whole_ms:.4f} ms "
        f"({whole_ms / split_ms:.1f}x), index_add_ {lib_ms:.4f} ms; split "
        f"at chunk {ops.CHUNK_ROWS} (the wrapper's) and "
        + ", ".join(f"{c} {ms:.4f} ms" for c, ms in by_chunk.items()))
    bound("segment_spmm hot segment (split)", e * d * 4 + 2 * e * 4
          + (n + 1) * 8 + n * d * 4, e * d, split_ms, rate=FP32_RATE,
          unit="fp32")
    del values, seg, plan, got, again, want, plain32
    torch.cuda.empty_cache()
    return err


def check_bag_shapes() -> float:
    """B5 against its plain version on the JAX tests' cases; returns the
    largest f32 error."""
    import torch
    from repro_torch.kernels.embedding_bag import ops, ref

    cases = [(f"V,D,B,K={v},{d},{b},{k}", v, d, b, k, v + b, False)
             for v, d, b, k in BAG_SHAPES]
    cases.append(("ids outside the table", 50, 8, 40, 3, 21, True))
    errs = {"float32": 0.0, "bfloat16": 0.0}
    for label, v, d, b, k, seed, outside in cases:
        rng = np.random.default_rng(seed)
        table = rng.standard_normal((v, d)).astype(np.float32)
        lo, hi = (-2 * v, 2 * v) if outside else (0, v)
        ids = torch.as_tensor(rng.integers(lo, hi, (b, k)).astype(np.int32),
                              device=DEVICE)
        w = torch.as_tensor(rng.standard_normal((b, k)).astype(np.float32),
                            device=DEVICE)
        for dt in errs:
            t = torch.as_tensor(table, device=DEVICE).to(getattr(torch, dt))
            got = ops.embedding_bag(t, ids, w)
            torch.cuda.synchronize()
            want = ref.embedding_bag(t.float(), ids, w)
            err = hold(f"embedding_bag {label} {dt}", got, want,
                       *TOL_BAG[dt])
            errs[dt] = max(errs[dt], err)
    table = torch.eye(8, 4, device=DEVICE)
    dup = ops.embedding_bag(table, torch.tensor(
        [[2, 2, 2, 0]], dtype=torch.int32, device=DEVICE), torch.tensor(
        [[1.0, 2.0, 3.0, 10.0]], device=DEVICE))
    if dup[0].tolist() != [10.0, 0.0, 6.0, 0.0]:
        raise SystemExit(f"embedding_bag: duplicate ids gave {dup.tolist()}")
    log(f"[kernel-vs-plain] embedding_bag on {len(cases)} cases x f32/bf16 "
        f"and duplicate ids: max abs err f32 {errs['float32']}, bf16 "
        f"{errs['bfloat16']} (tolerances {TOL_BAG})")
    return errs["float32"]


def check_bag_fields() -> float:
    """The grouped B5 (x0 in one launch) against its plain version on
    small batches: six fields of mixed vocabularies (3 to 20,000 rows),
    ids outside the tables and negative ids, ids, weights and dense
    columns as strided views, with and without dense columns, at B = 5
    (one block), 512 and 5,000 (x0 rows that start on and off 16 bytes);
    f32 and bf16 tables (a bf16 x0 without dense columns, an f32 one
    with them).  Returns the largest f32 error."""
    import torch
    from repro_torch.kernels.embedding_bag import ops, ref

    rng = np.random.default_rng(31)
    vocabs, d, k, n_dense = (100, 7, 1000, 50, 3, 20_000), 16, 4, 13
    errs = {"float32": 0.0, "bfloat16": 0.0}
    for b in (5, 512, 5000):
        tables = [rng.standard_normal((v, d)).astype(np.float32)
                  for v in vocabs]
        ids = np.stack([rng.integers(-v - 3, v + 3, (b, 2 * k))
                        for v in vocabs for _ in (0, 1)], 1)
        ids = torch.as_tensor(ids.astype(np.int32), device=DEVICE)[
            :, ::2, ::2]
        w = torch.as_tensor(rng.standard_normal(
            (b, 2 * len(vocabs), k)).astype(np.float32), device=DEVICE)[
                :, 1::2]
        dense = torch.as_tensor(rng.standard_normal(
            (b, 2 * n_dense)).astype(np.float32), device=DEVICE)[:, ::2]
        for dt in errs:
            tabs = [torch.as_tensor(t, device=DEVICE).to(getattr(torch, dt))
                    for t in tables]
            for x in (dense, None):
                got = ops.embedding_bag_fields(tabs, ids, w, x)
                torch.cuda.synchronize()
                want = ref.embedding_bag_fields([t.float() for t in tabs],
                                                ids, w, x)
                err = hold(f"embedding_bag_fields B={b} {dt} dense="
                           f"{x is not None}", got, want, *TOL_BAG[dt])
                errs[dt] = max(errs[dt], err)
    log(f"[kernel-vs-plain] embedding_bag_fields on 3 batches x f32/bf16 x "
        f"with and without dense columns ({len(vocabs)} fields of "
        f"{vocabs} rows, ids outside the tables, strided views): max abs "
        f"err f32 {errs['float32']}, bf16 {errs['bfloat16']} (tolerances "
        f"{TOL_BAG})")
    return errs["float32"]


def spmm_layer(label, h, g, n, bound, reps, per_forward):
    """B4 on one gin-tu layer's aggregation, the gather fused (rows
    ``plan.compose(src)`` of ``h``) and not (``rows = order`` over the
    materialised ``h[src]``): bitwise the same, and the same in two
    launches, and equal to the plain version; then timed beside the plan
    build, the gather, the plain version and ``index_add_``.  Logs the
    per-forward times for ``per_forward`` aggregations, the fused and the
    unfused bound, and the rate of the rows the fused kernel gathers.
    Returns ``(err, (ms, plain_ms, bound_ms, bound_by, library_ms))``."""
    import torch
    from repro_torch.kernels.segment_spmm import ops, ref

    src, dst, mask = g["edge_src"], g["edge_dst"], g["edge_mask"]
    plan = ops.plan(dst, n, mask)
    rows = plan.compose(src)
    fused = ops.segment_sum(h, plan, rows)
    again = ops.segment_sum(h, plan, rows)
    msg = h[src.long()]
    unfused = ops.segment_sum(msg, plan)
    torch.cuda.synchronize()
    if not (torch.equal(fused, again) and torch.equal(fused, unfused)):
        raise SystemExit(f"{label}: the fused and unfused sums, or two "
                         "launches, differ")
    err = hold(f"{label} vs plain", fused,
               ref.scatter_sum(msg, dst, n, mask), *TOL_SPMM["float32"])
    del fused, again, unfused
    d = h.shape[1]
    fns = {
        "plan": lambda: ops.plan(dst, n, mask),
        "fused": lambda: ops.launch_kernel(h, plan, rows),
        "unfused": lambda: ops.launch_kernel(msg, plan, plan.order),
        "gather": lambda: h[src.long()],
        "plain": lambda: ref.segment_sum(h, rows, plan.sorted_ids, n),
        "index_add_": lambda: torch.zeros(
            (n, d), dtype=h.dtype, device=DEVICE).index_add_(0, dst, msg),
    }
    ms = {}
    for name, fn in fns.items():
        fn()
        ms[name] = cuda_ms(fn, reps)
    kept = int(plan.offsets[-1])
    e = dst.numel()
    gathered = kept * d * h.element_size()
    b_ms, by = bound(f"{label} fused (h once)", h.numel() * h.element_size()
                     + 2 * e * 4 + (n + 1) * 8 + n * d * h.element_size(),
                     kept * d, ms["fused"], rate=FP32_RATE, unit="fp32")
    bound(f"{label} unfused (today's count: messages once)",
          msg.numel() * msg.element_size() + e * 4 + mask.numel()
          + n * d * msg.element_size(), kept * d, ms["unfused"],
          rate=FP32_RATE, unit="fp32")
    log(f"[gnn] {label}: fused kernel {ms['fused']:.4f} ms (gathers "
        f"{gathered} bytes of h rows, {gathered / ms['fused'] / 1e6:.0f} "
        f"GB/s), unfused {ms['unfused']:.4f} ms, plan build "
        f"{ms['plan']:.4f} ms, h[src] gather {ms['gather']:.4f} ms, plain "
        f"{ms['plain']:.4f} ms, index_add_ {ms['index_add_']:.4f} ms "
        f"(means of {reps}); per forward of {per_forward} aggregations: "
        f"plan + kernels {ms['plan'] + per_forward * ms['fused']:.4f} ms, "
        f"index_add_ {per_forward * ms['index_add_']:.4f} ms (+ gathers "
        f"{per_forward * ms['gather']:.4f} ms)")
    return err, (ms["fused"], ms["plain"], b_ms, by, ms["index_add_"])


def gnn_minibatch(bound):
    """The three GNN archs at full width on ``minibatch_lg``; returns B4's
    launches in the counted runs, its largest error on the layers' real
    inputs and its timing on gin-tu's first aggregation."""
    import torch
    import torch.nn.functional as F
    from repro_torch import configs
    from repro_torch.configs.gnn_common import _specialize
    from repro_torch.data.graph_data import random_graph_batch
    from repro_torch.kernels.segment_spmm import ops, ref
    from repro_torch.models import gnn
    from repro_torch.models.params import tree_init

    shape = configs.get_arch("gin-tu").shape("minibatch_lg")
    t0 = time.perf_counter()
    g_cpu = random_graph_batch(
        n_nodes=shape.n_nodes, n_edges=shape.n_edges, d_feat=shape.d_feat,
        n_classes=shape.n_classes, seed=0, device="cpu")
    g = tree_to(g_cpu, DEVICE)
    log(f"[gnn] minibatch_lg: {shape.n_nodes} nodes, {shape.n_edges} edges, "
        f"d_feat {shape.d_feat}, {shape.n_classes} classes, made in "
        f"{time.perf_counter() - t0:.1f}s")
    launches, err, timing = 0, 0.0, None
    for seed, (name, per_forward) in enumerate(GNN_MODELS):
        cfg = _specialize(configs.get_arch(name).config, shape)
        p = tree_init(gnn.gnn_param_specs(cfg), generator=torch.Generator(
            device=DEVICE).manual_seed(seed), device=DEVICE)
        # B4 on the first aggregation input of each width, recorded on a
        # warm-up forward
        firsts = {}
        for args in record_calls(ops, "segment_sum",
                                 lambda: gnn.forward(p, g, cfg)):
            firsts.setdefault(args[0].shape[1], args)
        for d, (values, plan, *rows) in firsts.items():
            rows = rows[0] if rows and rows[0] is not None else plan.order
            got = ops.segment_sum(values, plan, rows)
            again = ops.segment_sum(values, plan, rows)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise SystemExit(f"segment_spmm {name}: two launches differ")
            e = hold(f"segment_spmm {name} layer input D={d}", got,
                     ref.segment_sum(values, rows, plan.sorted_ids,
                                     plan.num_segments),
                     *TOL_SPMM["float32"])
            err = max(err, e)
            log(f"[gnn] {name}: B4 on the first aggregation input "
                f"[{values.shape[0]}, {d}] (rows {rows.shape[0]}) == plain, "
                f"max abs err {e}, bitwise the same in two launches")
        want = gnn.forward(tree_to(p, "cpu"), g_cpu, cfg)
        (out, times), _, counts = run_counted(
            f"{name} minibatch_lg x{TIMED_RUNS}",
            lambda: timed_runs_of(lambda: gnn.forward(p, g, cfg)),
            {"segment_spmm": per_forward * TIMED_RUNS,
             "segment_plan": TIMED_RUNS})
        launches += counts["segment_spmm"]
        e = hold(f"{name} forward on the card vs the CPU", out.cpu(), want,
                 *scaled_tol(want, GNN_TOL))
        log(f"[gnn] {name} ({cfg.n_layers} layers, d_hidden "
            f"{cfg.d_hidden}): forward == CPU forward (max abs err {e}, "
            f"|logits| <= {float(want.abs().max()):.3f}); ms per forward "
            + ", ".join(f"{t * 1e3:.3f}" for t in times) + f"; edges/s "
            f"best {shape.n_edges / min(times):.0f}; "
            f"{per_forward} B4 launches and 1 segment plan per forward")
        profiled("gnn", f"{name} minibatch_lg forward",
                 lambda: gnn.forward(p, g, cfg))
        if name == "gin-tu":
            h = F.relu(g["node_feat"] @ p["w_in"] + p["b_in"])
            e, timing = spmm_layer("segment_spmm gin-tu minibatch_lg layer 1",
                                   h, g, shape.n_nodes, bound, KERNEL_REPS,
                                   per_forward)
            err = max(err, e)
            del h
        del p, firsts, out, want
    return launches, err, timing


def gnn_ogb_products(bound):
    """gin-tu at full width on ``ogb_products``: B4 on the first layer's
    aggregation, fused and not, against its plain version, then one
    counted forward (no ``[E, D]`` message tensor) with its peak device
    memory.  Returns B4's launches and error."""
    import torch
    import torch.nn.functional as F
    from repro_torch import configs
    from repro_torch.configs.gnn_common import _specialize, padded_sizes
    from repro_torch.data.graph_data import random_graph_batch
    from repro_torch.models import gnn
    from repro_torch.models.params import tree_init

    arch = configs.get_arch("gin-tu")
    shape = arch.shape("ogb_products")
    n_pad, e_pad = padded_sizes(shape)
    t0 = time.perf_counter()
    g = random_graph_batch(
        n_nodes=shape.n_nodes, n_edges=shape.n_edges, d_feat=shape.d_feat,
        n_classes=shape.n_classes, seed=0, pad_nodes=n_pad, pad_edges=e_pad,
        device=DEVICE)
    log(f"[gnn] ogb_products: {shape.n_nodes} nodes padded to {n_pad}, "
        f"{shape.n_edges} edges padded to {e_pad}, made and copied in "
        f"{time.perf_counter() - t0:.1f}s")
    cfg = _specialize(arch.config, shape)
    p = tree_init(gnn.gnn_param_specs(cfg), generator=torch.Generator(
        device=DEVICE).manual_seed(0), device=DEVICE)
    h = F.relu(g["node_feat"] @ p["w_in"] + p["b_in"])
    err, _ = spmm_layer("segment_spmm gin-tu ogb_products layer 1", h, g,
                        n_pad, bound, 3, cfg.n_layers)
    # the materialised h[src] of the check is freed before the peak; one
    # warm-up forward takes the allocator's first allocations out of the
    # timed one
    del h
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    gnn.forward(p, g, cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    out, dt, counts = run_counted("gin-tu ogb_products forward",
                                  lambda: gnn.forward(p, g, cfg),
                                  {"segment_spmm": cfg.n_layers,
                                   "segment_plan": 1})
    if out.shape != (n_pad, shape.n_classes) or not bool(
            torch.isfinite(out).all()):
        raise SystemExit("gin-tu ogb_products: logits not finite or of "
                         f"shape {tuple(out.shape)}")
    peak = torch.cuda.max_memory_allocated()
    msg_bytes = e_pad * cfg.d_hidden * 4
    if peak - held >= msg_bytes:
        raise SystemExit(f"gin-tu ogb_products: the forward took {peak - held}"
                         f" bytes, room for an [E, D] message tensor "
                         f"({msg_bytes})")
    log(f"[gnn] gin-tu ogb_products: one forward {dt * 1e3:.1f} ms "
        f"({e_pad / dt:.0f} edges/s), finite [{n_pad}, "
        f"{shape.n_classes}] logits; peak device memory "
        f"{peak / 1e9:.2f} GB, of which {held / 1e9:.2f} GB graph and "
        f"params (an [E, D] message tensor would be {msg_bytes / 1e9:.2f} "
        f"GB)")
    del out
    profiled("gnn", "gin-tu ogb_products forward",
             lambda: gnn.forward(p, g, cfg))
    del g, p
    torch.cuda.empty_cache()
    return counts["segment_spmm"], err


def dcn_batch(cfg, b, seed):
    """The JAX recsys tests' batch (uniform ids per field, unit weights),
    on the host and on the card."""
    import torch

    rng = np.random.default_rng(seed)
    arrays = {
        "dense": rng.standard_normal((b, cfg.n_dense)).astype(np.float32),
        "sparse_ids": np.stack([rng.integers(0, v, (b, cfg.bag_size))
                                for v in cfg.vocab_sizes], 1).astype(
                                    np.int32),
        "sparse_weights": np.ones((b, cfg.n_sparse, cfg.bag_size),
                                  np.float32),
    }
    cpu = {k: torch.as_tensor(v) for k, v in arrays.items()}
    return cpu, tree_to(cpu, DEVICE)


def bag_fields_bound(bound, label, tables, b, ms):
    """The grouped B5's bound on one batch, counted as the single field's:
    int32 ids and f32 weights, each distinct row of each table once, the
    dense columns read and x0 written once, against 2 x B x F x K x D
    fp32 operations."""
    import torch

    ids, dense = b["sparse_ids"], b["dense"]
    n_bags, n_fields, k = ids.shape
    d = tables[0].shape[1]
    rows = sum(int(torch.unique(ids[:, f]).numel())
               for f in range(n_fields))
    n_bytes = (n_bags * n_fields * k * (4 + 4) + rows * d * 4
               + dense.numel() * 4 + n_bags * (dense.shape[1]
                                               + n_fields * d) * 4)
    return bound(label, n_bytes, 2 * n_bags * n_fields * k * d, ms,
                 rate=FP32_RATE, unit="fp32")


def check_fields_at(label, tables, b):
    """The grouped B5 against its plain version on every field of one
    DCN-v2 batch; returns the error."""
    import torch
    from repro_torch.kernels.embedding_bag import ops, ref

    args = (tables, b["sparse_ids"], b["sparse_weights"], b["dense"])
    got = ops.embedding_bag_fields(*args)
    torch.cuda.synchronize()
    err = hold(f"embedding_bag_fields {label}", got,
               ref.embedding_bag_fields(*args), *TOL_BAG["float32"])
    log(f"[dcn] embedding_bag_fields == plain on all {len(tables)} fields "
        f"at {label} (x0 {tuple(got.shape)}, max abs err {err})")
    return err


def dcn_serving(bound):
    """DCN-v2 at full width: serve_p99 against the CPU, the grouped B5 on
    every field at serve_p99 and serve_bulk, the single-field B5 on each
    field at serve_bulk (alone, and 26 launches into x0 as a forward would
    make them), serve_bulk timed, retrieval_cand against the CPU.  Returns
    the grouped B5's launches in the counted runs (the main path's), its
    largest error, and its timing at serve_bulk."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import dcn_v2
    from repro_torch.kernels.embedding_bag import ops, ref
    from repro_torch.models import recsys
    from repro_torch.models.params import tree_init

    cfg = dcn_v2.CONFIG
    shapes = {s.name: s for s in dcn_v2.RECSYS_SHAPES}
    t0 = time.perf_counter()
    p = tree_init(recsys.dcn_param_specs(cfg), generator=torch.Generator(
        device=DEVICE).manual_seed(0), device=DEVICE)
    torch.cuda.synchronize()
    p_cpu = tree_to(p, "cpu")
    tables = [p["tables"][f"t{i}"] for i in range(cfg.n_sparse)]
    log(f"[dcn] {cfg.n_params()} params ({sum(cfg.vocab_sizes)} table rows "
        f"x {cfg.embed_dim}, item table {cfg.n_items} x "
        f"{cfg.d_retrieval}) made on the card and copied to the host in "
        f"{time.perf_counter() - t0:.1f}s")
    launches = {"embedding_bag_fields": 0}
    errs = {"embedding_bag_fields": 0.0}

    # serve_p99: the card's forward against the CPU's
    b_cpu, b = dcn_batch(cfg, shapes["serve_p99"].batch, 1)
    errs["embedding_bag_fields"] = check_fields_at("serve_p99", tables, b)
    p99 = lambda: ops.embedding_bag_fields(
        tables, b["sparse_ids"], b["sparse_weights"], b["dense"])
    p99_ms = graph_ms(p99)
    log(f"[dcn] embedding_bag_fields serve_p99: {p99_ms:.4f} ms on the "
        f"card per launch (graph replay); {cuda_ms(p99, KERNEL_REPS):.4f} "
        "ms per call with the wrapper's host time (CUDA events)")
    bag_fields_bound(bound, "embedding_bag_fields serve_p99", tables, b,
                     p99_ms)
    want = recsys.forward(p_cpu, b_cpu, cfg)
    recsys.forward(p, b, cfg)
    (out, times), _, counts = run_counted(
        f"dcn-v2 serve_p99 x{TIMED_RUNS}",
        lambda: timed_runs_of(lambda: recsys.forward(p, b, cfg)),
        {"embedding_bag_fields": TIMED_RUNS})
    launches["embedding_bag_fields"] += counts["embedding_bag_fields"]
    e = hold("dcn-v2 serve_p99 forward on the card vs the CPU", out.cpu(),
             want, *scaled_tol(want, DCN_TOL))
    log(f"[dcn] serve_p99 (B={b['dense'].shape[0]}): forward == CPU forward "
        f"(max abs err {e}, |logits| <= {float(want.abs().max()):.3f}); ms "
        "per forward " + ", ".join(f"{t * 1e3:.3f}" for t in times)
        + "; 1 B5 launch per forward")
    profiled("dcn", "serve_p99 forward", lambda: recsys.forward(p, b, cfg))

    # serve_bulk: the grouped B5 against its plain version, timed beside
    # the single-field B5 on each field, F.embedding_bag and a concat
    b_cpu, b = dcn_batch(cfg, shapes["serve_bulk"].batch, 2)
    n_bags = b["dense"].shape[0]
    ids_all, w_all, dense = (b["sparse_ids"], b["sparse_weights"],
                             b["dense"])
    errs["embedding_bag_fields"] = max(errs["embedding_bag_fields"],
                                       check_fields_at("serve_bulk", tables,
                                                       b))
    grouped = lambda: ops.embedding_bag_fields(tables, ids_all, w_all, dense)
    plain_fields = lambda: ref.embedding_bag_fields(tables, ids_all, w_all,
                                                    dense)
    fields_ms = graph_ms(grouped)
    fields_plain_ms = cuda_ms(plain_fields, 3)
    library = lambda: torch.cat([dense] + [F.embedding_bag(
        ids_all[:, i], t, mode="sum", per_sample_weights=w_all[:, i])
        for i, t in enumerate(tables)], dim=-1)
    library_ms = graph_ms(library)
    fields_bound = bag_fields_bound(
        bound, f"embedding_bag_fields serve_bulk, all {cfg.n_sparse} "
        "fields", tables, b, fields_ms)
    # where the grouped launch's time goes: the fields of large (HBM),
    # medium and small (L2) tables, each range in one launch of its own
    vocab = torch.as_tensor(cfg.vocab_sizes)
    for label, sel in (("vocab >= 1M", vocab >= 1_000_000),
                       ("vocab 100k-1M", (vocab >= 100_000)
                        & (vocab < 1_000_000)),
                       ("vocab < 100k", vocab < 100_000)):
        idx = torch.nonzero(sel).flatten().tolist()
        if not idx:
            continue
        part = {"sparse_ids": ids_all[:, idx], "dense": dense[:, :0]}
        sub = ([tables[i] for i in idx], part["sparse_ids"],
               w_all[:, idx])
        part_ms = graph_ms(lambda: ops.embedding_bag_fields(*sub))
        log(f"[dcn] embedding_bag_fields serve_bulk, the {len(idx)} fields "
            f"of {label}: {part_ms:.4f} ms")
        bag_fields_bound(bound, f"embedding_bag_fields serve_bulk, "
                         f"{label}", sub[0], part, part_ms)
    timing = {"embedding_bag_fields": (fields_ms, fields_plain_ms,
                                       *fields_bound, None)}
    # the single-field B5 (F = 1) on each field: held against its plain
    # version, timed alone (each field's graph replayed on its own keeps
    # that field's ids, weights and small table in L2) and as a forward
    # would run it (one graph of 26 launches in field order, each writing
    # its columns of x0 in place after the dense columns' copy)
    d = cfg.embed_dim
    nd = dense.shape[1]
    field_ms, bag_err = [], 0.0
    for i, table in enumerate(tables):
        ids, w = ids_all[:, i], w_all[:, i]
        bag_err = max(bag_err, hold(
            f"embedding_bag serve_bulk field {i}",
            ops.embedding_bag(table, ids, w),
            ref.embedding_bag(table, ids, w), *TOL_BAG["float32"]))
        field_ms.append(graph_ms(lambda: ops.embedding_bag(table, ids, w)))
        if i == 0:
            lib0_ms = graph_ms(lambda: F.embedding_bag(
                ids, table, mode="sum", per_sample_weights=w))
    x0 = torch.empty((n_bags, nd + len(tables) * d), device=DEVICE)

    def per_field_x0():
        x0[:, :nd].copy_(dense)
        for f, table in enumerate(tables):
            ops.embedding_bag(table, ids_all[:, f], w_all[:, f],
                              out=x0[:, nd + f * d:nd + (f + 1) * d])
        return x0

    per_field_ms = graph_ms(per_field_x0)
    if not torch.equal(per_field_x0(), grouped()):
        raise SystemExit("embedding_bag: 26 single-field launches into x0 "
                         "differ from the grouped launch")
    del x0
    log(f"[dcn] embedding_bag (F = 1) == plain on all {cfg.n_sparse} fields "
        f"at serve_bulk (max abs err {bag_err}); field 0 alone "
        f"{field_ms[0]:.4f} ms (F.embedding_bag {lib0_ms:.4f} ms); the "
        f"{cfg.n_sparse} fields each alone {sum(field_ms):.4f} ms ("
        + ", ".join(f"{m:.4f}" for m in field_ms) + ")")
    bag_fields_bound(bound, f"embedding_bag serve_bulk, {cfg.n_sparse} "
                     "single-field launches into x0 (one graph)", tables, b,
                     per_field_ms)
    log(f"[dcn] x0 at serve_bulk ({n_bags} x {nd + cfg.n_sparse * d}): "
        f"embedding_bag_fields {fields_ms:.4f} ms in one launch; "
        f"{cfg.n_sparse} single-field launches into x0 in one graph "
        f"{per_field_ms:.4f} ms (bitwise equal); {cfg.n_sparse} "
        f"F.embedding_bag + torch.cat {library_ms:.4f} ms; plain "
        f"{fields_plain_ms:.4f} ms")
    recsys.forward(p, b, cfg)
    (out, times), _, counts = run_counted(
        f"dcn-v2 serve_bulk x{TIMED_RUNS}",
        lambda: timed_runs_of(lambda: recsys.forward(p, b, cfg)),
        {"embedding_bag_fields": TIMED_RUNS})
    launches["embedding_bag_fields"] += counts["embedding_bag_fields"]
    if out.shape != (n_bags,) or not bool(torch.isfinite(out).all()):
        raise SystemExit("dcn-v2 serve_bulk: logits not finite")
    log(f"[dcn] serve_bulk (B={n_bags}, bag {cfg.bag_size}): ms per forward "
        + ", ".join(f"{t * 1e3:.3f}" for t in times)
        + f"; examples/s best {n_bags / min(times):.0f}")
    profiled("dcn", "serve_bulk forward", lambda: recsys.forward(p, b, cfg))
    del b, b_cpu, out, ids_all, w_all, dense

    # retrieval_cand: one query against 1M candidates, top 100
    shape = shapes["retrieval_cand"]
    q_cpu, q = dcn_batch(cfg, shape.batch, 3)
    cand_cpu = torch.as_tensor(np.random.default_rng(4).permutation(
        cfg.n_items)[:shape.n_candidates].astype(np.int32))
    cand = cand_cpu.to(DEVICE)
    want_s, want_i = recsys.retrieval_step(p_cpu, q_cpu, cand_cpu, cfg,
                                           top_k=TOP_K)
    recsys.retrieval_step(p, q, cand, cfg, top_k=TOP_K)
    ((top_s, top_i), times), _, counts = run_counted(
        f"dcn-v2 retrieval_cand x{TIMED_RUNS}",
        lambda: timed_runs_of(lambda: recsys.retrieval_step(
            p, q, cand, cfg, top_k=TOP_K)),
        {"embedding_bag_fields": TIMED_RUNS})
    launches["embedding_bag_fields"] += counts["embedding_bag_fields"]
    e = hold("dcn-v2 retrieval scores on the card vs the CPU", top_s.cpu(),
             want_s, *scaled_tol(want_s, DCN_TOL))
    gaps = (want_s[:, 1:] - want_s[:, :-1]).abs() > 1e-5
    distinct = torch.ones_like(want_s, dtype=torch.bool)
    distinct[:, 1:] &= gaps
    distinct[:, :-1] &= gaps
    if not torch.equal(top_i.cpu()[distinct], want_i[distinct]):
        raise SystemExit("dcn-v2 retrieval: top ids differ from the CPU's "
                         "where the scores are distinct")
    log(f"[dcn] retrieval_cand: 1 query x {shape.n_candidates} candidates, "
        f"top {TOP_K} == CPU (score err {e}; ids equal at "
        f"{int(distinct.sum())} distinct scores); ms per call "
        + ", ".join(f"{t * 1e3:.3f}" for t in times))
    profiled("dcn", "retrieval_cand", lambda: recsys.retrieval_step(
        p, q, cand, cfg, top_k=TOP_K))
    del p, p_cpu, tables
    torch.cuda.empty_cache()
    return launches, errs, timing


# -- streaming and serving (phases 11-12) ----------------------------------

def edge_range(graph, lo: int, hi: int):
    """Edges ``[lo, hi)`` of ``graph`` as a graph of their own."""
    from repro_torch.core.temporal_graph import TemporalGraph

    return TemporalGraph(u=graph.u[lo:hi], v=graph.v[lo:hi],
                         t=graph.t[lo:hi], n_nodes=graph.n_nodes)


def closed_prefix(graph, closed_time: int):
    """The edges of ``graph`` with ``t < closed_time``."""
    return edge_range(graph, 0, int(np.searchsorted(graph.t, closed_time,
                                                    side="left")))


def timed_snapshot(miner):
    """One cold (first of its epoch) ``miner.snapshot()``: ``(result, wall
    ms, decode ms)``.  The decode of the tail's count rows into strings is
    timed after a synchronize, so the mine (plan, layout, kernel, fold) is
    the wall time less the decode."""
    import torch
    from repro_torch.core import transitions

    orig, spent = transitions.device_counts_to_dict, []

    def decode(counts):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(counts)
        spent.append(time.perf_counter() - t0)
        return out

    transitions.device_counts_to_dict = decode
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        snap = miner.snapshot()
        wall = time.perf_counter() - t0
    finally:
        transitions.device_counts_to_dict = orig
    return snap, wall * 1e3, sum(spent) * 1e3


def stream_replay(miner, graph, bounds):
    """``graph`` through ``miner`` by ``replay_stream`` in STREAM_CHUNK
    chunks, one call per span of ``bounds``, with a snapshot at each inner
    bound (the middle one timed cold, mine against decode) and the
    miner's state at the middle one; then the final snapshot."""
    from repro_torch.core.streaming import replay_stream

    lat, secs, snaps, state, split = [], 0.0, [], None, None
    middle = len(bounds) // 2
    for k, (a, b) in enumerate(zip(bounds[:-1], bounds[1:]), start=1):
        part, s = replay_stream(miner, edge_range(graph, a, b), STREAM_CHUNK)
        lat += part
        secs += s
        if k == len(bounds) - 1:
            break
        if k == middle:
            snap, wall_ms, decode_ms = timed_snapshot(miner)
            split = (wall_ms, decode_ms)
            state = miner.state_dict()
        else:
            snap = miner.snapshot()
        snaps.append((b, miner.closed_time, snap.counts))
    return lat, secs, snaps, state, split, miner.snapshot(final=True)


def streaming_phase(engine, graph, full_counts) -> dict:
    """Phase 11: ``engine.stream()`` over the full-size graph in 4,096-edge
    chunks; each quartile's snapshot equals ``discover`` on the closed
    prefix, the final one the fused ``discover`` of the whole graph; the
    same replay with ``fused="off"`` (B3) gives the same counts; a state
    taken at 50% and restored into a fresh miner ends at the same final
    counts.  Returns the counted replays' launches."""
    from repro_torch.core import MiningConfig, PTMTEngine
    from repro_torch.obs.timing import latency_summary

    n = graph.n_edges
    bounds = [0, *(k * n // 4 // STREAM_CHUNK * STREAM_CHUNK
                   for k in (1, 2, 3)), n]
    miner = engine.stream()
    (lat, secs, snaps, state, split, final), _, counts = run_counted(
        "stream fused", lambda: stream_replay(miner, graph, bounds),
        {"fused_zone_scan_flat": None})
    launches = {"fused_zone_scan_flat": counts["fused_zone_scan_flat"]}
    for edges, closed, got in snaps:
        want = engine.discover(closed_prefix(graph, closed)).counts
        if got != want:
            raise SystemExit(f"stream: snapshot after {edges} edges != "
                             f"discover on its closed prefix")
    if final.counts != full_counts:
        raise SystemExit("stream: final snapshot != fused discover")
    digest = latency_summary(lat)
    log(f"[stream] {len(lat)} chunks of {STREAM_CHUNK} edges: "
        f"{n / secs:.0f} edges/s ingest, chunk p50 {digest['p50_ms']:.3f} "
        f"p99 {digest['p99_ms']:.3f} max {digest['max_ms']:.3f} ms; "
        f"{miner.n_zones_finalized} zones finalized, "
        f"{miner.n_edges_retired} edges retired; B1 launches "
        f"{launches['fused_zone_scan_flat']}; snapshots at "
        f"{[s[0] for s in snaps]} edges == discover on the closed prefix, "
        f"final == fused discover ({len(final.counts)} codes)")
    log(f"[stream] cold snapshot at {bounds[2]} edges: {split[0]:.3f} ms, "
        f"mine {split[0] - split[1]:.3f} ms, decode {split[1]:.3f} ms "
        f"({miner.last_tail_layout['n_zones']} tail zones)")

    off = PTMTEngine(MiningConfig(backend="cuda", fused="off",
                                  **FULL_PARAMS), device=DEVICE).stream()
    (lat, secs, snaps_off, _, _, final_off), _, counts = run_counted(
        "stream fused=off", lambda: stream_replay(off, graph, bounds),
        {"zone_scan_dense": None})
    launches["zone_scan_dense"] = counts["zone_scan_dense"]
    if [s[2] for s in snaps_off] != [s[2] for s in snaps] \
            or final_off.counts != full_counts:
        raise SystemExit("stream fused='off': counts differ from the fused "
                         "replay")
    log(f"[stream] fused='off' replay == fused replay at every snapshot and "
        f"at the end; {n / secs:.0f} edges/s, B3 launches "
        f"{launches['zone_scan_dense']}")

    restored = engine.stream()
    restored.restore_state(state)
    rest = edge_range(graph, bounds[2], n)
    from repro_torch.core.streaming import replay_stream

    profiled("stream", f"replay of the last {rest.n_edges} edges after a "
             "restore", lambda: replay_stream(restored, rest, STREAM_CHUNK))
    if restored.snapshot(final=True).counts != full_counts:
        raise SystemExit("stream: restored miner's final counts differ")
    log(f"[stream] state at {bounds[2]} edges restored into a fresh miner, "
        f"fed the rest: final counts == the uninterrupted replay's")
    return launches


def serving_phase(engine, graph, solo) -> dict:
    """Phase 12: ``serve_motifs``'s single-service workload (4 tenants
    strided from the full-size graph), ``--verify``'s check, co-mining
    over {600, 300} x {6, 4}, a threaded first query of an epoch beside
    another tenant's ingest, then cluster mode with a failover and a cold
    restart.  Returns the counted runs' launches."""
    import tempfile
    import threading

    from repro_torch.launch import serve_motifs as sm
    from repro_torch.serving.cluster import ClusterCoordinator
    from repro_torch.serving.motif import MotifService, QueryRequest

    names = [f"tenant{i}" for i in range(SERVE_TENANTS)]
    streams = sm.tenant_streams(graph, SERVE_TENANTS)
    service = MotifService(engine=engine, ingest_batch=SERVE_BATCH)
    for name in names:
        service.create_session(name)

    def workload():
        t0 = time.perf_counter()
        out = sm.run_workload(service, streams, names,
                              chunk_edges=SERVE_CHUNK,
                              queries_per_chunk=SERVE_QUERIES, seed=0)
        return out, time.perf_counter() - t0

    ((ingest_lat, query_lat, first_lat), wall), _, counts = run_counted(
        "serve", workload, {"fused_zone_scan_flat": None})
    launches = {"fused_zone_scan_flat": counts["fused_zone_scan_flat"]}
    report = sm.build_report(service, names, graph.n_edges, wall,
                             ingest_lat, query_lat, first_lat)
    log(f"[serve] {SERVE_TENANTS} tenants, chunk {SERVE_CHUNK}, admission "
        f"{SERVE_BATCH}, {SERVE_QUERIES} queries per chunk: "
        f"{report['ingest_edges_per_s']:.0f} edges/s, ingest p50 "
        f"{report['ingest_p50_ms']:.3f} p99 {report['ingest_p99_ms']:.3f} "
        f"ms; {report['queries']} steady queries p50 "
        f"{report['query_p50_ms']:.3f} p99 {report['query_p99_ms']:.3f} ms; "
        f"{report['first_calls']} first calls (max "
        f"{report['first_call_max_ms']:.3f} ms); cache hit rate "
        f"{report['cache_hit_rate']:.3f}, {report['snapshots_mined']} "
        f"snapshots mined; B1 launches {launches['fused_zone_scan_flat']}")
    for op, row in report["per_op"].items():
        log(f"  {op}: n={row['count']} p50 {row['p50_ms']:.3f} ms, p99 "
            f"{row['p99_ms']:.3f} ms")
    for row in sm.verify_against_batch(
            service, names, streams, delta=FULL_PARAMS["delta"],
            l_max=FULL_PARAMS["l_max"], omega=FULL_PARAMS["omega"],
            backend="cuda", device=DEVICE):
        if row["match"] is not True:
            raise SystemExit(f"serve: {row['tenant']} != discover on its "
                             f"closed prefix ({row})")
    served = {name: service.manager.get(name).engine().result.counts
              for name in names}
    log(f"[serve] --verify: every tenant == discover on its closed prefix "
        f"({', '.join(str(len(c)) for c in served.values())} codes)")

    comine = MotifService(engine=engine, ingest_batch=SERVE_BATCH)
    for d, lm in COMINE:
        comine.create_session(f"d{d}-l{lm}", delta=d, l_max=lm)
    results, dt, counts = run_counted(
        "serve comine", lambda: comine.comine(graph),
        {"fused_zone_scan_flat_ts": 1})
    launches["fused_zone_scan_flat_ts"] = counts["fused_zone_scan_flat_ts"]
    for (d, lm), want in zip(COMINE, solo):
        if results[f"d{d}-l{lm}"].counts != want.counts:
            raise SystemExit(f"serve comine: {d}/{lm} != its discover")
    log(f"[serve] comine over {COMINE} == 4 independent discover, one B1-ts "
        f"launch, {dt:.3f}s")

    # one tenant's first query of an epoch mines (outside its session's
    # lock) while another tenant ingests and finalizes, on one executor
    threaded = MotifService(engine=engine, ingest_batch=SERVE_BATCH)
    (a, ga), (b, gb) = zip(names[:2], streams[:2])
    half = ga.n_edges // 2
    for name, g in ((a, ga), (b, gb)):
        threaded.create_session(name)
        threaded.ingest(name, g.u[:half], g.v[:half], g.t[:half])
        threaded.flush(name)
    miner_b = threaded.manager.get(b).miner
    mine_b, in_mine, ingesting, errors = miner_b.mine_view, \
        threading.Event(), threading.Event(), []

    def held(view):
        in_mine.set()
        if not ingesting.wait(120):
            raise RuntimeError("the ingest thread never started")
        return mine_b(view)

    def query():
        try:
            threaded.query(QueryRequest(session=b, op="total"))
        except Exception as exc:        # reported below, fails the run
            errors.append(exc)

    def ingest():
        try:
            if not in_mine.wait(120):
                raise RuntimeError("the query never reached its mine")
            ingesting.set()
            threaded.ingest(a, ga.u[half:], ga.v[half:], ga.t[half:])
            threaded.flush(a)
        except Exception as exc:        # reported below, fails the run
            errors.append(exc)

    miner_b.mine_view = held
    threads = [threading.Thread(target=query),
               threading.Thread(target=ingest)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    miner_b.mine_view = mine_b
    if errors or any(t.is_alive() for t in threads):
        raise SystemExit(f"serve threaded: {errors or 'a thread hung'}")
    for name, g in ((a, ga), (b, gb)):
        sess = threaded.manager.get(name)
        want = engine.discover(closed_prefix(g, sess.closed_time)).counts
        if sess.engine().result.counts != want:
            raise SystemExit(f"serve threaded: {name} != discover on its "
                             "closed prefix")
    log(f"[serve] threaded: {b}'s first query of an epoch mined while {a} "
        f"ingested {ga.n_edges - half} edges ({time.perf_counter() - t0:.3f}"
        f"s); both == discover on their closed prefixes")

    with tempfile.TemporaryDirectory() as ckdir:
        def coordinator():
            return ClusterCoordinator(
                2, config=engine.config, checkpoint_dir=ckdir,
                ingest_batch=SERVE_BATCH, device=DEVICE)

        co = coordinator()
        for name in names:
            co.create_tenant(name)
            co.checkpoint(name, {"offset": 0})
        halves = [edge_range(g, 0, g.n_edges // 2) for g in streams]
        cluster = dict(chunk_edges=SERVE_CHUNK, queries_per_chunk=1,
                       checkpoint_every=SERVE_BATCH)
        t0 = time.perf_counter()
        first, _, counts = run_counted(
            "cluster first half", lambda: sm.run_cluster_workload(
                co, halves, names, **cluster),
            {"fused_zone_scan_flat": None})
        launches["fused_zone_scan_flat"] += counts["fused_zone_scan_flat"]
        victim = co.owner_of(names[0])
        t1 = time.perf_counter()
        recovered = co.kill_worker(victim)
        failover_ms = (time.perf_counter() - t1) * 1e3
        rewound = {t: int(m["offset"]) for t, m in recovered.items()}
        offsets = {**first["offsets"], **rewound}
        second, _, counts = run_counted(
            "cluster after failover", lambda: sm.run_cluster_workload(
                co, streams, names, offsets=offsets, seed=1, **cluster),
            {"fused_zone_scan_flat": None})
        launches["fused_zone_scan_flat"] += counts["fused_zone_scan_flat"]
        co.flush_all()
        wall = time.perf_counter() - t0
        for name in names:
            if sm.tenant_counts(co, name) != served[name]:
                raise SystemExit(f"cluster: {name} after failover != the "
                                 "uninterrupted service's counts")
        run = {k: first[k] + second[k] for k in (
            "ingest_lat", "edges_fed", "throttle_events",
            "checkpoints_written")}
        run["query_lat"] = {op: first["query_lat"][op]
                            + second["query_lat"][op]
                            for op in first["query_lat"]}
        run["first_call_lat"] = {op: first["first_call_lat"][op]
                                 + second["first_call_lat"][op]
                                 for op in first["first_call_lat"]}
        rep = sm.build_cluster_report(co, names, run, graph.n_edges, wall,
                                      mode="failover")
        log(f"[cluster] 2 workers, {victim} killed after half of each "
            f"stream: {sorted(recovered)} restored in {failover_ms:.3f} ms "
            f"and rewound to {rewound}; "
            f"{rep['edges_fed']} edges fed, {rep['ingest_edges_per_s']:.0f} "
            f"edges/s, ingest p50 {rep['ingest_p50_ms']:.3f} p99 "
            f"{rep['ingest_p99_ms']:.3f} ms, query p50 "
            f"{rep['query_p50_ms']:.3f} p99 {rep['query_p99_ms']:.3f} ms, "
            f"cache hit rate {rep['cache_hit_rate']:.3f}, "
            f"{rep['checkpoints_written']} checkpoints, "
            f"{rep['snapshots_mined']} snapshots mined; every tenant == the "
            "uninterrupted service's counts")
        co.checkpoint_all({n: {"offset": second["offsets"][n]}
                           for n in names})
        t1 = time.perf_counter()
        cold = coordinator()
        back = cold.restore_all()
        restart_ms = (time.perf_counter() - t1) * 1e3
        for name, g in zip(names, streams):
            if back[name]["offset"] != g.n_edges or \
                    sm.tenant_counts(cold, name) != served[name]:
                raise SystemExit(f"cluster: {name} after a cold restart "
                                 "!= the uninterrupted service's counts")
        log(f"[cluster] cold restart from the store: {len(back)} tenants in "
            f"{restart_ms:.3f} ms, counts byte for byte the service's")
    return launches


# -- sharded mining and training (phases 13-14) ----------------------------

def counts_digest(counts: dict) -> str:
    """SHA-256 of a count dict in sorted order: equal digests, equal
    tables (the ranks of phase 13 report theirs)."""
    import hashlib

    return hashlib.sha256(json.dumps(sorted(counts.items())).encode()
                          ).hexdigest()


def full_size_graph(n_edges: int = FULL_EDGES):
    from repro_torch.data import synthetic_graphs

    gen, _ = synthetic_graphs.DATASET_ANALOGS["email-eu-like"]
    return gen(n_edges=n_edges, n_nodes=FULL_NODES, seed=0)


def shard_config(params):
    """Phase 13's mining config: the main path's, with each rank's zones
    folded into a carry of ``SHARD_CAP`` rows."""
    from repro_torch.core import MiningConfig

    return MiningConfig(backend="cuda", agg="hierarchical",
                        merge_cap=SHARD_CAP, **params)


def shard_rank(rank: int, store: str, out: str, run: dict) -> None:
    """One of phase 13's gloo ranks on ``cuda:0`` (started by
    ``torch.multiprocessing.spawn``; ``run`` carries the parent's device,
    edge count and mining parameters): the full-size graph mined by
    ``engine.sharded`` on a ``(2, 2)`` mesh in both merge modes, each run
    with the launch counts at 0 before it and read after; writes its
    report (digests, B3 launches, seconds; rank 0 also the counts)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import PTMTEngine
    from repro_torch.kernels.zone_scan import ops

    device = torch.device(run["device"])
    if device.type == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, SHARD_RANKS),
                            rank=rank, world_size=SHARD_RANKS)
    try:
        mesh = init_device_mesh(device.type, SHARD_MESH,
                                mesh_dim_names=SHARD_AXES)
        graph = full_size_graph(run["edges"])
        engine = PTMTEngine(shard_config(run["params"]), device=device)
        sync = torch.cuda.synchronize if device.type == "cuda" \
            else (lambda: None)
        engine.sharded(graph, mesh, out_cap=SHARD_CAP)   # warm-up
        report = {}
        for mode in ("flat", "hierarchical"):
            ops.reset_launches()
            dist.barrier()
            sync()
            t0 = time.perf_counter()
            res = engine.sharded(graph, mesh, out_cap=SHARD_CAP,
                                 merge_mode=mode)
            sync()
            report[mode] = {
                "seconds": time.perf_counter() - t0,
                "zone_scan_dense": ops.launches["zone_scan_dense"],
                "digest": counts_digest(res.counts),
                "n_zones": res.n_zones,
                "counts": sorted(res.counts.items()) if rank == 0 else None,
            }
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump(report, f)
    finally:
        dist.destroy_process_group()


def sharded_phase(full_counts) -> int:
    """Phase 13: ``engine.sharded`` at the mining full size on a one-rank
    NCCL ``DeviceMesh`` in this process, then on four gloo ranks spawned
    on ``cuda:0`` as a ``(2, 2)`` mesh (NCCL refuses two ranks on one
    card; the group's backend sends the <= out_cap payload through host
    memory), both merge modes; every result equals the fused ``discover``
    byte for byte.  Returns the B3 launches of the counted runs."""
    import tempfile

    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import PTMTEngine

    graph = full_size_graph()
    want = counts_digest(full_counts)
    launches = 0
    on_card = torch.device(DEVICE).type == "cuda"
    with tempfile.TemporaryDirectory() as tmp:
        if on_card:
            torch.cuda.set_device(0)
        dist.init_process_group(
            "nccl" if on_card else "gloo",
            store=dist.FileStore(os.path.join(tmp, "nccl"), 1), rank=0,
            world_size=1)
        try:
            mesh = init_device_mesh(torch.device(DEVICE).type, (1,),
                                    mesh_dim_names=("z",))
            engine = PTMTEngine(shard_config(FULL_PARAMS), device=DEVICE)
            engine.sharded(graph, mesh, out_cap=SHARD_CAP)  # warm-up
            for mode in ("flat", "hierarchical"):
                res, dt, counts = run_counted(
                    f"sharded nccl x1 {mode}",
                    lambda: engine.sharded(graph, mesh,
                                           out_cap=SHARD_CAP,
                                           merge_mode=mode),
                    {"zone_scan_dense": None})
                launches += counts["zone_scan_dense"]
                if res.counts != full_counts:
                    raise SystemExit(f"sharded (1 NCCL rank, {mode}) != "
                                     "fused discover")
                log(f"[sharded] 1 NCCL rank, {mode}: == fused discover "
                    f"({len(res.counts)} codes, {res.n_zones} zones), "
                    f"{dt:.3f}s, {graph.n_edges / dt:.0f} edges/s, "
                    f"{counts['zone_scan_dense']} B3 launches")
        finally:
            dist.destroy_process_group()

        t0 = time.perf_counter()
        run = {"device": DEVICE, "edges": graph.n_edges,
               "params": FULL_PARAMS}
        mp.spawn(shard_rank, args=(os.path.join(tmp, "gloo"), tmp, run),
                 nprocs=SHARD_RANKS, join=True)
        spawn_s = time.perf_counter() - t0
        reports = []
        for r in range(SHARD_RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                reports.append(json.load(f))
    for mode in ("flat", "hierarchical"):
        rows = [rep[mode] for rep in reports]
        if any(row["digest"] != want for row in rows):
            raise SystemExit(f"sharded ({SHARD_RANKS} gloo ranks, {mode}): "
                             "a rank's counts != fused discover")
        if dict(map(tuple, rows[0]["counts"])) != full_counts:
            raise SystemExit(f"sharded ({SHARD_RANKS} gloo ranks, {mode}): "
                             "rank 0's counts != fused discover")
        per_rank = [row["zone_scan_dense"] for row in rows]
        if min(per_rank) == 0:
            raise SystemExit(f"sharded {mode}: a rank launched no B3 "
                             f"({per_rank})")
        launches += sum(per_rank)
        secs = [row["seconds"] for row in rows]
        log(f"[sharded] {SHARD_RANKS} gloo ranks on cuda:0, mesh "
            f"{SHARD_MESH} {SHARD_AXES}, {mode}: every rank == fused "
            f"discover ({rows[0]['n_zones']} zones), seconds per rank "
            + ", ".join(f"{s:.3f}" for s in secs)
            + f" ({graph.n_edges / max(secs):.0f} edges/s at the slowest); "
            f"B3 launches per rank {per_rank}")
    log(f"[sharded] the {SHARD_RANKS} ranks took {spawn_s:.1f}s from spawn "
        "to join (start-up, graph, plan, a warm-up, both modes)")
    return launches


def grads_close(label, got, want) -> str:
    """Every leaf of a gradient tree on the card against the CPU's (see
    ``TRAIN_FROB``); returns a summary: the largest relative norm of the
    difference, the largest elementwise error over the leaf's largest
    |grad|, and the elements outside rtol/atol ``TRAIN_TOL`` (atol scaled
    by that largest |grad|)."""
    from repro_torch.training.tree import flatten_with_paths

    want = dict(flatten_with_paths(want))
    frob = rel = 0.0
    outside = total = 0
    for path, g in flatten_with_paths(got):
        w = want[path].double()
        d = (g.detach().cpu().double() - w).abs()
        scale = max(float(w.abs().max()), 1e-30)
        f = float(d.norm() / max(float(w.norm()), 1e-30))
        if not f <= TRAIN_FROB:
            raise SystemExit(f"{label} {path}: |difference| / |CPU "
                             f"gradient| = {f:.3e} > {TRAIN_FROB}")
        frob, rel = max(frob, f), max(rel, float(d.max()) / scale)
        outside += int((d > TRAIN_TOL * (scale + w.abs())).sum())
        total += d.numel()
    return (f"largest |difference| / |gradient| {frob:.2e}, largest "
            f"elementwise error {rel:.2e} of the leaf's max |grad|, "
            f"{outside} of {total} elements outside rtol/atol {TRAIN_TOL}")


def tree_double(tree):
    """A tree of CPU float64 copies of its floating-point leaves."""
    return {k: tree_double(v) if isinstance(v, dict) else (
        v.detach().cpu().double() if v.is_floating_point() else v.cpu())
        for k, v in tree.items()}


def check_spmm_backward(g, n, bound):
    """B4's backward at gin-tu's ``minibatch_lg`` shapes: the gradient of
    a ``h[src]`` sum with respect to ``h`` [N, 64], B4 on the transposed
    plan, against its plain version on the same inputs and against the
    transposed sum written out (``index_add_`` of ``grad[dst]`` into the
    sources); timed beside the transposed plan, the plain version and
    that ``index_add_``.  Returns ``(err, timing)``."""
    import torch
    from repro_torch.kernels.segment_spmm import ops, ref

    src, dst, mask = g["edge_src"], g["edge_dst"], g["edge_mask"]
    d = 64
    grad = torch.randn((n, d), generator=torch.Generator(
        device=DEVICE).manual_seed(7), device=DEVICE)
    plan = ops.plan(dst, n, mask)
    rows = plan.compose(src)
    t_plan, t_rows = transposed = ops.transpose(plan, rows, n)
    got = ops.row_grad(grad, transposed)
    again = ops.row_grad(grad, transposed)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise SystemExit("segment_spmm backward: two launches differ")
    err = hold("segment_spmm backward vs plain", got,
               ref.segment_sum(grad, t_rows, t_plan.sorted_ids, n),
               *TOL_SPMM["float32"])
    keep = mask & (dst >= 0) & (dst < n)
    msgs = grad[dst.long().clamp(0, n - 1)]
    err = max(err, hold("segment_spmm backward vs grad[dst] summed by src",
                        got, ref.scatter_sum(msgs, src, n, keep),
                        *TOL_SPMM["float32"]))
    fns = {
        "kernel": lambda: ops.launch_kernel(grad, t_plan, t_rows,
                                            count="segment_spmm_backward"),
        "transpose": lambda: ops.transpose(plan, rows, n),
        "plain": lambda: ref.segment_sum(grad, t_rows, t_plan.sorted_ids, n),
        "gather": lambda: grad[dst.long()],
        "index_add_": lambda: torch.zeros((n, d), device=DEVICE).index_add_(
            0, src, msgs),
    }
    ms = {}
    for name, fn in fns.items():
        fn()
        ms[name] = cuda_ms(fn, KERNEL_REPS)
    kept = int(t_plan.offsets[-1])
    e = src.numel()
    b_ms, by = bound("segment_spmm backward (transposed plan, grad once)",
                     grad.numel() * 4 + 2 * e * 4 + (n + 1) * 8 + n * d * 4,
                     kept * d, ms["kernel"], rate=FP32_RATE, unit="fp32")
    log(f"[train] segment_spmm backward at minibatch_lg [{n}, {d}]: == "
        f"plain (max abs err {err}), bitwise the same in two launches; "
        f"kernel {ms['kernel']:.4f} ms, transposed plan "
        f"{ms['transpose']:.4f} ms, plain {ms['plain']:.4f} ms, index_add_ "
        f"{ms['index_add_']:.4f} ms (+ grad[dst] gather {ms['gather']:.4f}"
        f" ms), means of {KERNEL_REPS}")
    return err, (ms["kernel"], ms["plain"], b_ms, by, ms["index_add_"])


def train_with_resume(label, step_fn, params, opt_state, batches, ckdir,
                      expect):
    """Five steps through ``train_loop.run``: three with a checkpoint
    every two steps, then a resume from the third to the fifth (counted:
    ``expect`` per step).  Returns ``(params, opt_state, ms per resumed
    step, counts)``."""
    from repro_torch.training import train_loop

    def loop(total):
        return train_loop.TrainLoopConfig(
            total_steps=total, ckpt_dir=ckdir, ckpt_every=2, log_every=1,
            metrics_path=os.path.join(ckdir, "metrics.jsonl"))

    _, _, first = train_loop.run(step_fn=step_fn, params=params,
                                 opt_state=opt_state, batches=batches(),
                                 loop_cfg=loop(3))
    (p, o, hist), _, counts = run_counted(
        f"{label} resumed steps 4-5", lambda: train_loop.run(
            step_fn=step_fn, params=params, opt_state=opt_state,
            batches=batches(), loop_cfg=loop(5), device=DEVICE),
        {k: 2 * n for k, n in expect.items()})
    if [h["step"] for h in hist] != [4, 5] or int(o.step) != 5:
        raise SystemExit(f"{label}: the resumed run did not continue from "
                         f"step 3 ({[h['step'] for h in hist]})")
    losses = [h["loss"] for h in first + hist]
    if not all(np.isfinite(losses)):
        raise SystemExit(f"{label}: a loss is not finite ({losses})")
    ms = [h["step_time_s"] * 1e3 for h in first + hist]
    log(f"[train] {label}: 5 AdamW steps (3, checkpoint, resume to 5), "
        f"losses " + ", ".join(f"{x:.4f}" for x in losses) + "; ms per "
        "step " + ", ".join(f"{x:.3f}" for x in ms))
    return p, o, ms, counts


def gnn_training(bound):
    """gin-tu, gat-cora and gatedgcn at full width on ``minibatch_lg``:
    the first step's loss and gradients on the card against the CPU's,
    every aggregation's gradient through B4's autograd Function, then 5
    AdamW steps through ``train_loop.run`` with a checkpoint and a
    resume; gin-tu's resumed run against an uninterrupted one.  Returns
    B4's forward and backward launches in the counted runs, its largest
    error and its backward timing."""
    import tempfile

    import torch
    from repro_torch import configs
    from repro_torch.configs.gnn_common import _specialize
    from repro_torch.data.graph_data import random_graph_batch
    from repro_torch.kernels.segment_spmm import ops
    from repro_torch.models import gnn
    from repro_torch.models.params import tree_init
    from repro_torch.training import optimizer
    from repro_torch.training.tree import leaves, value_and_grad

    shape = configs.get_arch("gin-tu").shape("minibatch_lg")
    g_cpu = random_graph_batch(
        n_nodes=shape.n_nodes, n_edges=shape.n_edges, d_feat=shape.d_feat,
        n_classes=shape.n_classes, seed=0, device="cpu")
    g = tree_to(g_cpu, DEVICE)
    err, timing = check_spmm_backward(g, shape.n_nodes, bound)
    launches = {"segment_spmm": 0, "segment_spmm_backward": 0}
    grad_fn = value_and_grad(gnn.loss_fn)
    opt_cfg = optimizer.AdamWConfig(lr=1e-3, warmup_steps=1)
    for seed, (name, per_forward) in enumerate(GNN_MODELS):
        cfg = _specialize(configs.get_arch(name).config, shape)
        p = tree_init(gnn.gnn_param_specs(cfg), generator=torch.Generator(
            device=DEVICE).manual_seed(seed), device=DEVICE)
        calls = {"row_grad": []}
        calls["edge_grad"] = record_calls(
            ops, "edge_grad", lambda: calls["row_grad"].extend(record_calls(
                ops, "row_grad", lambda: calls.setdefault(
                    "out", grad_fn(p, g, cfg)))))
        loss, grads = calls["out"]
        n_aggs = len(calls["edge_grad"]) + len(calls["row_grad"])
        if n_aggs != per_forward:
            raise SystemExit(f"{name}: {n_aggs} aggregation gradients "
                             f"through B4's Function, expected "
                             f"{per_forward}")
        loss_c, grads_c = grad_fn(tree_to(p, "cpu"), g_cpu, cfg)
        hold(f"{name} loss on the card vs the CPU", loss.cpu(), loss_c,
             TRAIN_TOL, 0.0)
        summary = grads_close(f"{name} gradient", grads, grads_c)
        yardstick = ""
        if name != "gatedgcn":      # its float64 run takes ~30 s
            _, grads_64 = grad_fn(tree_double(p), tree_double(g_cpu), cfg)
            yardstick = (f"; the CPU's float32 gradient against float64: "
                         f"{grads_close(f'{name} CPU', grads_c, grads_64)}")
            del grads_64
        log(f"[train] {name} minibatch_lg: first step's loss "
            f"{float(loss):.6f} (CPU {float(loss_c):.6f}); gradients on "
            f"the card against the CPU's: {summary}{yardstick}; {n_aggs} "
            f"aggregation gradients through B4's Function "
            f"({len(calls['row_grad'])} on the transposed plan)")
        del grads, grads_c

        def step_fn(params, opt_state, batch):
            loss, grads = grad_fn(params, batch, cfg)
            params, opt_state, metrics = optimizer.apply_updates(
                opt_cfg, params, grads, opt_state)
            metrics["loss"] = loss
            torch.cuda.synchronize()
            return params, opt_state, metrics

        def batches():
            while True:
                yield g

        bwd = cfg.n_layers if cfg.kind in ("gin", "gcn") else 0
        expect = {"segment_spmm": per_forward, "segment_plan": 1}
        if bwd:
            expect.update(segment_spmm_backward=bwd,
                          segment_plan_backward=1)
        with tempfile.TemporaryDirectory() as ckdir:
            p_res, o_res, ms, counts = train_with_resume(
                f"{name} minibatch_lg", step_fn, p,
                optimizer.init_state(p), batches, ckdir, expect)
        launches["segment_spmm"] += counts["segment_spmm"]
        launches["segment_spmm_backward"] += counts["segment_spmm_backward"]
        if name == "gin-tu":
            with tempfile.TemporaryDirectory() as ckdir:
                from repro_torch.training import train_loop

                p_all, o_all, _ = train_loop.run(
                    step_fn=step_fn, params=p,
                    opt_state=optimizer.init_state(p), batches=batches(),
                    loop_cfg=train_loop.TrainLoopConfig(
                        total_steps=5, ckpt_dir=ckdir, ckpt_every=5))
            diff = max(float((a - b).abs().max()) for a, b in zip(
                leaves((p_res, o_res)), leaves((p_all, o_all))))
            log(f"[train] gin-tu: the resumed run's parameters and moments "
                f"against 5 uninterrupted steps: max abs diff {diff} "
                f"({'bitwise' if diff == 0 else 'not bitwise'})")
        profiled("train", f"{name} minibatch_lg training step",
                 lambda: step_fn(p, optimizer.init_state(p), g))
        del p, p_res, o_res
    return launches, err, timing


def check_bag_backward(tables, b, bound):
    """``embedding_bag_fields_backward`` at ``train_batch`` (65,536 x 26
    fields x bag 4) against its plain version (one ``index_add_`` per
    field) on the same inputs; timed adding into zeroed buffers, beside
    the plain version, the buffers' zeroing and 26 ``index_add_`` calls
    on the weighted rows made beforehand.  Returns ``(err, timing)``."""
    import torch
    from repro_torch.kernels.embedding_bag import ops, ref

    ids, w = b["sparse_ids"], b["sparse_weights"]
    n_bags, n_fields, k = ids.shape
    d = tables[0].shape[1]
    n_dense = b["dense"].shape[1]
    vocabs = [t.shape[0] for t in tables]
    grad_x0 = torch.randn((n_bags, n_dense + n_fields * d),
                          generator=torch.Generator(device=DEVICE)
                          .manual_seed(9), device=DEVICE)
    got = ops.launch_fields_backward_kernel(tables, ids, w, grad_x0, n_dense)
    want = ref.embedding_bag_fields_backward(vocabs, ids, w, grad_x0,
                                             n_dense)
    torch.cuda.synchronize()
    err = 0.0
    for f, (a, bb) in enumerate(zip(got, want)):
        # atomics and index_add_ sum a row's adds in other orders
        err = max(err, hold(f"embedding_bag_fields_backward field {f}", a,
                            bb, *scaled_tol(bb, TOL_BAG["float32"][0])))
    del got, want
    bufs = [torch.zeros((v, d), device=DEVICE) for v in vocabs]
    idx = [ids[:, f].long().reshape(-1) for f in range(n_fields)]
    adds = [(w[:, f, :, None] * grad_x0[:, None, n_dense + f * d:
                                        n_dense + (f + 1) * d])
            .reshape(-1, d) for f in range(n_fields)]
    ms = {
        "kernel": cuda_ms(lambda: ops.launch_fields_backward_kernel(
            tables, ids, w, grad_x0, n_dense, into=bufs), KERNEL_REPS),
        "zeros": cuda_ms(lambda: [x.zero_() for x in bufs], 3),
        "plain": cuda_ms(lambda: ref.embedding_bag_fields_backward(
            vocabs, ids, w, grad_x0, n_dense), 3),
        "index_add_": cuda_ms(lambda: [x.index_add_(0, i, a) for x, i, a in
                                       zip(bufs, idx, adds)], KERNEL_REPS),
    }
    rows = sum(int(torch.unique(ids[:, f]).numel())
               for f in range(n_fields))
    n_bytes = (n_bags * n_fields * k * (4 + 4) + n_bags * n_fields * d * 4
               + rows * d * 4)
    b_ms, by = bound("embedding_bag_fields_backward train_batch", n_bytes,
                     2 * n_bags * n_fields * k * d, ms["kernel"],
                     rate=FP32_RATE, unit="fp32")
    log(f"[train] embedding_bag_fields_backward at train_batch "
        f"({n_bags} x {n_fields} fields x bag {k}, {rows} distinct rows "
        f"touched): == plain per field (max abs err {err}); kernel "
        f"{ms['kernel']:.4f} ms (mean of {KERNEL_REPS}, adding into "
        f"zeroed buffers), zeroing the {sum(vocabs)} x {d} buffers "
        f"{ms['zeros']:.4f} ms, plain {ms['plain']:.4f} ms, 26 index_add_ "
        f"on ready weighted rows {ms['index_add_']:.4f} ms")
    del bufs, idx, adds
    return err, (ms["kernel"], ms["plain"], b_ms, by, ms["index_add_"])


def dcn_training(bound):
    """DCN-v2 at full width (CONFIG): a step's loss and gradients on the
    card against the CPU's at 512 examples (every table gets one), B5's
    backward against its plain version at ``train_batch``, then
    ``train_batch`` steps (value_and_grad + AdamW) timed and one
    profiled.  Returns B5's forward and backward launches in the counted
    run, its backward's error and timing."""
    import torch
    from repro_torch.configs import dcn_v2
    from repro_torch.models import recsys
    from repro_torch.models.params import tree_init
    from repro_torch.training import optimizer
    from repro_torch.training.tree import value_and_grad

    cfg = dcn_v2.CONFIG
    shapes = {s.name: s for s in dcn_v2.RECSYS_SHAPES}
    p = tree_init(recsys.dcn_param_specs(cfg), generator=torch.Generator(
        device=DEVICE).manual_seed(0), device=DEVICE)
    grad_fn = value_and_grad(recsys.loss_fn)

    def labelled(b, seed):
        b_cpu, b = dcn_batch(cfg, b, seed)
        y = torch.as_tensor(np.random.default_rng(seed).integers(
            0, 2, b_cpu["dense"].shape[0]).astype(np.float32))
        return {**b_cpu, "labels": y}, {**b, "labels": y.to(DEVICE)}

    b_cpu, b = labelled(512, 4)
    loss, grads = grad_fn(p, b, cfg)
    loss_c, grads_c = grad_fn(tree_to(p, "cpu"), b_cpu, cfg)
    hold("dcn-v2 loss on the card vs the CPU", loss.cpu(), loss_c,
         TRAIN_TOL, 0.0)
    summary = grads_close("dcn-v2 gradient", grads, grads_c)
    empty = [k for k, t in grads["tables"].items()
             if float(t.abs().max()) == 0]
    if empty:
        raise SystemExit(f"dcn-v2: tables {empty} got no gradient")
    log(f"[train] dcn-v2 at 512 examples: loss {float(loss):.6f} (CPU "
        f"{float(loss_c):.6f}); gradients on the card against the CPU's: "
        f"{summary}; all {cfg.n_sparse} tables got a gradient")
    del grads, grads_c

    _, b = labelled(shapes["train_batch"].batch, 5)
    tables = [p["tables"][f"t{i}"] for i in range(cfg.n_sparse)]
    err, timing = check_bag_backward(tables, b, bound)
    opt_cfg = optimizer.AdamWConfig(lr=1e-3, warmup_steps=1)
    state = {"p": p, "o": optimizer.init_state(p)}

    def step():
        loss, grads = grad_fn(state["p"], b, cfg)
        state["p"], state["o"], _ = optimizer.apply_updates(
            opt_cfg, state["p"], grads, state["o"])
        return loss

    step()
    torch.cuda.reset_peak_memory_stats()
    (losses, times), _, counts = run_counted(
        f"dcn-v2 train_batch x{TIMED_RUNS}", lambda: timed_runs_of(step),
        {"embedding_bag_fields": TIMED_RUNS,
         "embedding_bag_fields_backward": TIMED_RUNS})
    peak = torch.cuda.max_memory_allocated() / 1e9
    n = shapes["train_batch"].batch
    log(f"[train] dcn-v2 train_batch (B={n}): ms per step (value_and_grad "
        "+ AdamW over all " + f"{cfg.n_params()} params) " + ", ".join(
            f"{t * 1e3:.3f}" for t in times) + f"; {n / min(times):.0f} "
        f"examples/s best; peak {peak:.2f} GB; 1 B5 forward and 1 B5 "
        "backward launch per step")

    def fwd_bwd():
        return grad_fn(state["p"], b, cfg)

    profiled("train", "dcn-v2 train_batch forward + backward", fwd_bwd)
    profiled("train", "dcn-v2 train_batch step (with AdamW)", step)
    return counts, err, timing


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: PyTorch sees no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core import MiningConfig, PTMTEngine, encoding, oracle
    from repro_torch.core.executor import fold_fused
    from repro_torch.data import synthetic_graphs
    from repro_torch.kernels import _build
    from repro_torch.kernels.zone_scan import ops, ref

    # every float32 matmul in full float32 (the CPU forwards are the
    # reference of the card's)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    # -- 1. device ------------------------------------------------------
    smi = nvidia_smi("name,power.limit")
    log(smi)
    kind = torch.cuda.get_device_name(0)
    props = torch.cuda.get_device_properties(0)
    sm_clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    log(f"[device] nvidia-smi: {smi}")
    log(f"[device] {kind}, {props.multi_processor_count} SMs, max SM clock "
        f"{sm_clock_mhz:.0f} MHz, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, python {sys.version.split()[0]}")

    # -- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"[build] {len(libs)} source(s) in "
        f"{time.perf_counter() - t0:.1f}s -> {_build.BUILD_DIR}; each: "
        + ", ".join(f"{k} {v:.1f}s" for k, v in
                    _build.build_seconds.items()))
    report_registers(_build.build_logs)

    # -- 3. kernels vs plain ------------------------------------------
    from repro_torch.core import tzp

    t_phase = time.perf_counter()
    errs = dict.fromkeys(ops.VARIANTS, 0)
    log("[kernel-vs-plain] bursty corpus: flat kernel (both variants) on "
        "the flat layout, dense kernel (both) on every bucket")
    bursty = powerlaw_bursty(5)
    loops = powerlaw_bursty(11, nodes=3)     # few nodes: many self-loops
    for gname, g, (d, lm, om) in (("bursty", bursty, (12, 3, 2)),
                                  ("bursty", bursty, (30, 7, 2)),
                                  ("self-loops", loops, (40, 5, 2))):
        plan = tzp.plan_zones(g, delta=d, l_max=lm, omega=om)
        lay = tzp.build_zone_layout(g, plan, layout="bucketed")
        label = f"{gname} delta={d} l_max={lm}"
        for bounds in ("full", "live"):
            fl = tzp.concat_layout(lay, blk=512, delta=d, l_max=lm,
                                   bounds=bounds)
            for with_ts in (False, True):
                check_flat(label, fl, delta=d, l_max=lm, with_ts=with_ts)
        for b in lay.buckets:
            check_dense(f"{label} bucket {b.label}", b, delta=d, l_max=lm)
    log(f"[kernel-vs-plain] adversarial rows for the dense kernel's hybrid "
        f"sweep (W={SOLO_SLOTS}): both variants at delta=1000")
    adversarial = adversarial_rows(SOLO_SLOTS)
    for lm in (6, 3):
        check_dense(f"adversarial rows l_max={lm}", adversarial, delta=1000,
                    l_max=lm)
    log("[kernel-vs-plain] the flat form (adversarial_flat: several zones "
        "per warp, zone ends at the solo/cooperative boundary, a row ending "
        "on the stream pad, a block's hi cutting a row) for the flat "
        "kernel's row ends: both variants at delta=1000")
    adversarial = adversarial_flat(SOLO_SLOTS)
    for lm in (6, 3):
        for with_ts in (False, True):
            check_flat(f"adversarial flat l_max={lm}", adversarial,
                       delta=1000, l_max=lm, with_ts=with_ts)
    del adversarial

    gen, _ = synthetic_graphs.DATASET_ANALOGS["email-eu-like"]
    graph = gen(n_edges=FULL_EDGES, n_nodes=FULL_NODES, seed=0)
    engine = PTMTEngine(MiningConfig(backend="cuda", **FULL_PARAMS),
                        device=DEVICE)
    if engine.executor.fused_bounds != "live":
        raise SystemExit("main path must plan live sweep bounds")
    plan, layout = engine._plan_and_layout(graph)
    fl, fold_chunk = engine.executor.fused_layout(layout)
    log(f"[full-size] email-eu-like: {graph.n_edges} edges, "
        f"{graph.n_nodes} nodes, {plan.n_zones} zones, buckets "
        f"{list(layout.bucket_shapes())}, {fl.valid_edges} valid slots, "
        f"{fl.n_slots} flat slots, sweep_slots {fl.sweep_slots}")
    d, lm = FULL_PARAMS["delta"], FULL_PARAMS["l_max"]
    limbs = encoding.n_limbs(lm)
    int_rate = props.multi_processor_count * 64 * sm_clock_mhz * 1e6
    log(f"[bound] integer rate {props.multi_processor_count} SMs x 64 x "
        f"{sm_clock_mhz:.0f} MHz = {int_rate / 1e12:.2f} Tops/s; bytes "
        f"over the published {HBM_RATE / 1e9:.0f} GB/s (measured copy rate "
        f"{copy_bandwidth() / 1e9:.0f} GB/s; card {smi})")

    def bound(name, n_bytes, n_ops, ms, rate=int_rate, unit="int"):
        bytes_ms = n_bytes / HBM_RATE * 1e3
        ops_ms = n_ops / rate * 1e3
        b_ms = max(bytes_ms, ops_ms)
        by = "bytes" if bytes_ms >= ops_ms else "operations"
        log(f"[bound] {name}: {n_ops} {unit} ops = {ops_ms:.4f} ms; {n_bytes} "
            f"bytes = {bytes_ms:.4f} ms; bound {b_ms:.4f} ms by {by}; "
            f"kernel {ms:.4f} ms, at {b_ms / ms:.1%} of its bound")
        return b_ms, by

    timing = {}
    # flat kernel, both variants, on the full-size stream
    steps = None
    for with_ts in (False, True):
        threads, per_sm = ops.flat_occupancy(lm, with_ts)
        resident = props.multi_processor_count * per_sm * threads
        log(f"[occupancy] {VARIANT_FLAT[with_ts]} l_max={lm}: {threads} "
            f"threads per block, {per_sm} blocks per SM, {resident} lanes "
            f"resident; {fl.n_slots / resident:.2f} waves over the "
            f"{fl.n_slots}-slot stream")
    for with_ts in (False, True):
        name = VARIANT_FLAT[with_ts]
        args, out, errs[name] = check_flat("full-size", fl, delta=d,
                                           l_max=lm, with_ts=with_ts)
        ms = cuda_ms(lambda: ops.launch_kernel(
            *args, delta=d, l_max=lm, blk=fl.blk, with_ts=with_ts),
            reps=KERNEL_REPS)
        plain_ms = cuda_ms(lambda: ref.fused_zone_scan_torch(
            *args, delta=d, l_max=lm, blk=fl.blk, with_ts=with_ts))
        if steps is None:
            lane_steps = ref.lane_steps(*args, delta=d, l_max=lm, blk=fl.blk)
            steps = int(lane_steps.sum())
            sweep_counts(f"flat stream ({fl.n_slots} slots)", lane_steps)
        n_bytes = (5 * 4 * fl.n_slots + 2 * 4 * fl.n_blocks
                   + (limbs + 1 + (lm if with_ts else 0)) * 4 * fl.n_slots)
        n_ops = steps * (OPS_FIXED + OPS_PER_NODE * (lm + 1))
        timing[name] = (ms, plain_ms, *bound(name, n_bytes, n_ops, ms))
        log(f"[full-size] {name}: kernel {ms:.4f} ms (mean of "
            f"{KERNEL_REPS}), plain {plain_ms:.1f} ms, {steps} live "
            f"lane-slots")
        if not with_ts:
            main_code, main_length = out
            spans = flat_span_ms(args, layout, delta=d, l_max=lm,
                                 blk=fl.blk)
            log(f"[full-size] {name} on each bucket's span of the stream: "
                + ", ".join(f"{label} ({n} slots) {span:.4f} ms"
                            for label, n, span in spans)
                + f"; {sum(x[2] for x in spans):.4f} ms in all")
    del args, out

    # dense kernel, both variants, timed on every bucket of the same
    # layout; held against its plain version (a per-edge torch loop that
    # takes minutes here) on the largest bucket alone, which is also the
    # shape its JSON entry reports
    largest = max(layout.buckets, key=lambda b: b.u.size)
    total_ms = dict.fromkeys((False, True), 0.0)
    for with_ts in (False, True):
        threads, per_sm = ops.dense_occupancy(lm, with_ts)
        resident = props.multi_processor_count * per_sm * threads
        log(f"[occupancy] {VARIANT_DENSE[with_ts]} l_max={lm}: {threads} "
            f"threads per block, {per_sm} blocks per SM, {resident} lanes "
            f"resident; waves per bucket " + ", ".join(
                f"{b.label} {b.u.size / resident:.2f}"
                for b in layout.buckets))
    for b in layout.buckets:
        if b is largest:
            args, plain_s, err = check_dense(
                f"full-size bucket {b.label}", b, delta=d, l_max=lm)
        else:
            args = batch_tensors(b, DEVICE)
        lane_steps = dense_lane_steps(args, delta=d, l_max=lm)
        n_steps = int(lane_steps.sum())
        sweep_counts(f"bucket {b.label}", lane_steps)
        for with_ts in (False, True):
            name = VARIANT_DENSE[with_ts]
            ms = cuda_ms(lambda: ops.launch_zone_kernel(
                *args, delta=d, l_max=lm, with_ts=with_ts), reps=KERNEL_REPS)
            total_ms[with_ts] += ms
            log(f"  {name} bucket {b.label}: kernel {ms:.4f} ms, "
                f"{n_steps} live lane-slots")
            if b is largest:
                errs[name] = err
                n_bytes = (4 + limbs + 1 + (lm if with_ts else 0)) * 4 \
                    * b.u.size
                n_ops = n_steps * (OPS_FIXED_DENSE + OPS_PER_NODE * (lm + 1))
                timing[name] = (ms, plain_s * 1e3, *bound(
                    f"{name} bucket {b.label}", n_bytes, n_ops, ms))
    for with_ts in (False, True):
        log(f"[full-size] {VARIANT_DENSE[with_ts]}: kernels "
            f"{total_ms[with_ts]:.4f} ms over {layout.n_buckets} buckets; "
            f"plain {timing[VARIANT_DENSE[with_ts]][1]:.1f} ms on bucket "
            f"{largest.label}")
    del args
    log(f"[kernel-vs-plain] phase {time.perf_counter() - t_phase:.1f}s")

    # -- 4. lossless TZP ------------------------------------------------
    cm = dict(delta=900, l_max=3, omega=6)
    college = synthetic_graphs.make("collegemsg-like")
    t0 = time.perf_counter()
    res = PTMTEngine(MiningConfig(backend="cuda", **cm),
                     device=DEVICE).discover(college)
    seq = PTMTEngine(MiningConfig(backend="ref", **cm),
                     device=DEVICE).sequential(college)
    if res.counts != seq.counts:
        raise SystemExit("collegemsg-like: discover(cuda) != sequential(ref)")
    log(f"[lossless] collegemsg-like: discover(cuda) == sequential(ref), "
        f"{len(res.counts)} codes, {res.total_processes()} processes "
        f"({time.perf_counter() - t0:.1f}s)")
    res = PTMTEngine(MiningConfig(backend="cuda", delta=12, l_max=3,
                                  omega=2), device=DEVICE).discover(bursty)
    expect = dict(oracle.count_codes(bursty.u, bursty.v, bursty.t, 12, 3))
    if res.counts != expect:
        raise SystemExit("bursty corpus: discover(cuda) != oracle")
    log(f"[lossless] bursty: discover(cuda) == brute-force oracle, "
        f"{len(res.counts)} codes")

    # -- 5. per-bucket paths at full size -------------------------------
    fused_res = engine.discover(graph)
    n_buckets = layout.n_buckets
    dense_launches = 0
    for agg, zc in (("legacy", None), ("hierarchical", 2),
                    ("pipelined", 2)):
        eng = PTMTEngine(MiningConfig(backend="cuda", fused="off", agg=agg,
                                      zone_chunk=zc, **FULL_PARAMS),
                         device=DEVICE)
        res, dt, counts = run_counted(
            f"per-bucket {agg}", lambda: eng.discover(graph),
            {"zone_scan_dense": n_buckets if zc is None else None})
        dense_launches += counts["zone_scan_dense"]
        if res.counts != fused_res.counts:
            raise SystemExit(f"per-bucket {agg} != fused discover")
        log(f"[lossless] full size: discover(cuda, fused='off', "
            f"agg={agg!r}, zone_chunk={zc}) == fused discover, "
            f"{len(res.counts)} codes, {graph.n_edges / dt:.0f} edges/s")
    seq_engine = PTMTEngine(MiningConfig(backend="cuda", **FULL_PARAMS),
                            device=DEVICE)
    res, dt, counts = run_counted("sequential", lambda: seq_engine.sequential(
        graph), {"zone_scan_dense": 1})
    dense_launches += counts["zone_scan_dense"]
    if res.counts != fused_res.counts:
        raise SystemExit("sequential(cuda) != fused discover")
    log(f"[lossless] full size: sequential(cuda), one dense launch over one "
        f"{graph.n_edges}-edge zone, == fused discover")
    seq_b = tzp.build_zone_layout(graph, tzp.single_zone_plan(
        graph, l_b=seq_engine.config.l_b), layout="dense").buckets[0]
    seq_args = batch_tensors(seq_b, DEVICE)
    seq_ms = cuda_ms(lambda: ops.launch_zone_kernel(
        *seq_args, delta=d, l_max=lm), reps=3)
    lane_steps = dense_lane_steps(seq_args, delta=d, l_max=lm)
    seq_steps = int(lane_steps.sum())
    sweep_counts("sequential (one zone)", lane_steps)
    bound("zone_scan_dense (sequential, one zone)",
          (4 + limbs + 1) * 4 * seq_b.u.size,
          seq_steps * (OPS_FIXED_DENSE + OPS_PER_NODE * (lm + 1)), seq_ms)
    del seq_args

    # -- 6. co-mining at full size --------------------------------------
    configs = [MiningConfig(backend="cuda", delta=dd, l_max=ll, omega=20)
               for dd, ll in COMINE]
    solo, dt_solo, _ = run_counted(
        "4 independent discover", lambda: [
            PTMTEngine(c, device=DEVICE).discover(graph) for c in configs],
        {"fused_zone_scan_flat": len(configs)})
    for fused, variant, n in (("auto", "fused_zone_scan_flat_ts", 1),
                              ("off", "zone_scan_dense_ts", n_buckets)):
        cfgs = [c.with_updates(fused=fused) for c in configs]
        eng = PTMTEngine(cfgs[0], device=DEVICE)
        many, dt, counts = run_counted(
            f"discover_many fused={fused}",
            lambda: eng.discover_many(graph, cfgs), {variant: None})
        # a per-bucket spill retry re-runs its bucket's launch; the fused
        # retry re-folds the kept output
        retried = many[0].layout["execution"]["spill_retries"]
        if counts[variant] != n and not (fused == "off" and retried
                                         and counts[variant] > n):
            raise SystemExit(f"discover_many fused={fused}: "
                             f"{counts[variant]} {variant} launches, "
                             f"expected {n}")
        if fused == "auto":
            flat_ts_launches = counts[variant]
        else:
            dense_ts_launches = counts[variant]
        for c, a, b in zip(cfgs, many, solo):
            if a.counts != b.counts:
                raise SystemExit(f"discover_many fused={fused}: member "
                                 f"{c.delta}/{c.l_max} != its discover")
        log(f"[co-mine] fused={fused}: discover_many == 4 discover, byte "
            f"for byte; {counts[variant]} {variant} launch(es); wall "
            f"{dt:.3f}s vs {dt_solo:.3f}s for the 4 discover calls; path "
            f"{many[0].layout['execution']['path']}")

    # -- 7. main path ---------------------------------------------------
    import repro_torch.obs as obs_mod

    t0 = time.perf_counter()
    warm = engine.discover(graph)
    log(f"[main] warm-up discover {time.perf_counter() - t0:.3f}s, "
        f"{len(warm.counts)} unique codes")
    traced = PTMTEngine(MiningConfig(backend="cuda", **FULL_PARAMS),
                        device=DEVICE, obs=obs_mod.enabled())
    res = traced.discover(graph)
    spans = {}
    for ev in traced.obs.tracer.events():
        spans[ev["name"]] = spans.get(ev["name"], 0.0) + ev["dur"] / 1e3
    log("[main] traced cold discover (ms, synced spans): " + ", ".join(
        f"{k} {v:.3f}" for k, v in spans.items()))
    if res.counts != warm.counts:
        raise SystemExit("traced run disagrees with the warm-up")

    # the fold alone, at the merge cap the warm engine now starts from
    merge_cap = engine.executor.fused_merge_cap(fl, fold_chunk)
    sign = torch.as_tensor(fl.sign, device=DEVICE)
    fold = lambda: fold_fused(main_code, main_length, sign,
                              fold_chunk=fold_chunk, merge_cap=merge_cap)
    fold()
    fold_ms = cuda_ms(fold, reps=3)
    log(f"[main] fold {fold_ms:.3f} ms (mean of 3; fold_chunk {fold_chunk}, "
        f"merge_cap {merge_cap})")
    del main_code, main_length, sign

    profiled("main", "warm discover", lambda: engine.discover(graph))

    def timed_runs():
        times, last = [], None
        for _ in range(TIMED_RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            last = engine.discover(graph)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if last.counts != warm.counts:
                raise SystemExit("timed run disagrees with the warm-up")
        return last, times

    (res, times), _, counts = run_counted(
        "main", timed_runs, {"fused_zone_scan_flat": TIMED_RUNS})
    launches = counts["fused_zone_scan_flat"]
    path = res.layout["execution"]["path"]
    if path != "fused":
        raise SystemExit(f"main path did not go through the kernel: "
                         f"path {path!r}")
    counts_arr = np.asarray(list(res.counts.values()))
    if not (len(counts_arr) and np.all(counts_arr > 0)):
        raise SystemExit("main path produced no positive counts")
    if res.total_processes() != graph.n_edges:
        raise SystemExit("every edge seeds exactly one process, but "
                         f"{res.total_processes()} != {graph.n_edges}")
    for i, dt in enumerate(times):
        log(f"[main] run {i}: {dt * 1e3:.3f} ms, "
            f"{graph.n_edges / dt:.0f} edges/s")
    log(f"[main] {smi}: edges/s best {graph.n_edges / min(times):.0f}, "
        f"kernel {timing['fused_zone_scan_flat'][0]:.4f} ms, fold "
        f"{fold_ms:.3f} ms, launches {launches} in {TIMED_RUNS} runs, path "
        f"{path}, {len(res.counts)} unique codes, {res.total_processes()} "
        f"processes")

    # -- 8. model-zoo kernels vs plain ----------------------------------
    t_phase = time.perf_counter()
    errs["segment_spmm"] = max(check_spmm_shapes(), spmm_hot_segment(bound))
    # the single-field entry point is the same kernel with F = 1
    errs["embedding_bag_fields"] = max(check_bag_shapes(),
                                       check_bag_fields())
    log(f"[kernel-vs-plain] model zoo phase "
        f"{time.perf_counter() - t_phase:.1f}s")

    # -- 9. GNN inference -----------------------------------------------
    t_phase = time.perf_counter()
    spmm_launches, spmm_err, timing["segment_spmm"] = gnn_minibatch(bound)
    n, err = gnn_ogb_products(bound)
    spmm_launches += n
    errs["segment_spmm"] = max(errs["segment_spmm"], spmm_err, err)
    log(f"[gnn] phase {time.perf_counter() - t_phase:.1f}s")

    # -- 10. DCN-v2 serving ---------------------------------------------
    t_phase = time.perf_counter()
    bag_launches, bag_errs, bag_timing = dcn_serving(bound)
    timing.update(bag_timing)
    for name, err in bag_errs.items():
        errs[name] = max(errs[name], err)
    log(f"[dcn] phase {time.perf_counter() - t_phase:.1f}s")

    # -- 11. streaming ---------------------------------------------------
    t_phase = time.perf_counter()
    stream_launches = streaming_phase(engine, graph, fused_res.counts)
    log(f"[stream] phase {time.perf_counter() - t_phase:.1f}s")

    # -- 12. serving -----------------------------------------------------
    t_phase = time.perf_counter()
    serve_launches = serving_phase(engine, graph, solo)
    log(f"[serve] phase {time.perf_counter() - t_phase:.1f}s")
    launches += stream_launches["fused_zone_scan_flat"] \
        + serve_launches["fused_zone_scan_flat"]
    flat_ts_launches += serve_launches["fused_zone_scan_flat_ts"]
    dense_launches += stream_launches["zone_scan_dense"]

    # -- 13. sharded mining ---------------------------------------------
    t_phase = time.perf_counter()
    dense_launches += sharded_phase(fused_res.counts)
    log(f"[sharded] phase {time.perf_counter() - t_phase:.1f}s")

    # -- 14. training ---------------------------------------------------
    t_phase = time.perf_counter()
    train_spmm, errs["segment_spmm_backward"], \
        timing["segment_spmm_backward"] = gnn_training(bound)
    spmm_launches += train_spmm["segment_spmm"]
    train_bag, errs["embedding_bag_fields_backward"], \
        timing["embedding_bag_fields_backward"] = dcn_training(bound)
    bag_launches["embedding_bag_fields"] += train_bag["embedding_bag_fields"]
    log(f"[train] phase {time.perf_counter() - t_phase:.1f}s")

    # -- 13. kernels ----------------------------------------------------
    rows = (
        ("fused_zone_scan_flat", SRC + "fused_zone_scan.cu", TPU + ":429",
         launches),
        ("fused_zone_scan_flat_ts", SRC + "fused_zone_scan.cu",
         TPU + ":429 (with_ts)", flat_ts_launches),
        ("zone_scan_dense", SRC + "zone_scan.cu", TPU + ":245",
         dense_launches),
        ("zone_scan_dense_ts", SRC + "zone_scan.cu", TPU + ":245 (with_ts)",
         dense_ts_launches),
        ("segment_spmm", SPMM_SRC, SPMM_TPU, spmm_launches),
        ("embedding_bag_fields", BAG_SRC, BAG_TPU + " (all fields, x0)",
         bag_launches["embedding_bag_fields"]),
        ("segment_spmm_backward", SPMM_SRC,
         SPMM_TPU + " (its transpose: the same kernel on the transposed "
         "plan; the JAX gradient is XLA's)",
         train_spmm["segment_spmm_backward"]),
        ("embedding_bag_fields_backward", BAG_SRC,
         BAG_TPU + " (its transpose, all fields; the JAX gradient is "
         "XLA's)", train_bag["embedding_bag_fields_backward"]),
    )
    kernels = []
    for name, src, replaces, n in rows:
        ms, plain_ms, bound_ms, bound_by, *library = timing[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": src,
            "replaces": replaces,
            "launches": n,
            "max_abs_err": errs[name],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": library[0] if library else None,
        })
    log(f"[done] {time.perf_counter() - t_start:.1f}s")
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
