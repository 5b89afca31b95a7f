#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Drives the port's main path — ``PTMTEngine.discover`` with
``backend="cuda"``, ``fused="auto"``, ``fused_bounds="live"`` — on the
card, through the hand-written kernels it launches, and checks it:

1. device: the card's name and power limit, torch and CUDA versions;
2. build: every CUDA source of the package, with nvcc, timed;
3. each kernel against its plain PyTorch version on the same CUDA
   tensors, slot for slot: on the power-law bursty corpus, and on the
   full-size layout (the ``email-eu-like`` generator at the edge count of
   SNAP's email-Eu-core-temporal, 332,334 edges, at the paper's defaults
   delta=600, l_max=6, omega=20);
4. lossless TZP: ``discover`` on ``backend="cuda"`` equals ``sequential``
   on ``backend="ref"`` (collegemsg-like), and the bursty corpus equals
   the brute-force oracle;
5. the main path on the full-size graph: one warm-up, a traced run for the
   time breakdown, then three timed runs with every kernel's launch count
   set to 0 before and read after;
6. one JSON line naming every kernel with its launches, error and times;
7. last line: ``{"ok": true, "device": {...}}``.

It exits non-zero, with no result line, when any phase fails or when
PyTorch sees no CUDA device.  Integer outputs are compared exactly
(tolerance 0).
"""

from __future__ import annotations

import json
import os
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
TIMED_RUNS = 3
KERNEL_REPS = 20
DEVICE = "cuda"
# per visited slot the kernel loads zone_id, valid, t, u, v (5), tests the
# zone and the validity (2), forms the gap and its two tests (3), and for
# each of the K = l_max + 1 node slots compares u and v and keeps the
# first hit of each (4 per slot); extensions (at most l_max per lane) are
# left out
OPS_FIXED, OPS_PER_NODE = 10, 4


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


def flat_tensors(fl, device):
    import torch

    return [torch.as_tensor(x, device=device) for x in (
        fl.u, fl.v, fl.t, fl.valid, fl.zone_id, fl.lo, fl.hi)]


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


def check_scan(name, fl, *, delta, l_max):
    """Kernel vs plain version on one flat layout; returns the tensors."""
    import torch
    from repro_torch.kernels.zone_scan import ops, ref

    args = flat_tensors(fl, DEVICE)
    code, length = ops.launch_kernel(*args, delta=delta, l_max=l_max,
                                     blk=fl.blk)
    torch.cuda.synchronize()
    p_code, p_length = ref.fused_zone_scan_torch(
        *args, delta=delta, l_max=l_max, blk=fl.blk)
    err = max(int((code - p_code).abs().max()),
              int((length - p_length).abs().max()))
    log(f"  {name}: S={fl.n_slots} valid={fl.valid_edges} "
        f"bounds={fl.bounds} max_abs_err={err}")
    if err:
        raise SystemExit(f"kernel != plain version on {name}")
    return args, code, length, err


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: PyTorch sees no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core import MiningConfig, PTMTEngine, oracle
    from repro_torch.core.executor import fold_fused
    from repro_torch.data import synthetic_graphs
    from repro_torch.kernels import _build
    from repro_torch.kernels.zone_scan import ops, ref

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
        f"{time.perf_counter() - t0:.1f}s -> {_build.BUILD_DIR}")
    for src, text in _build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {src}: {line.strip()}")

    # -- 3. kernel vs plain -------------------------------------------
    from repro_torch.core import tzp

    log("[kernel-vs-plain] fused_zone_scan_flat")
    bursty = powerlaw_bursty(5)
    loops = powerlaw_bursty(11, nodes=3)     # few nodes: many self-loops
    for gname, g, (d, lm, om) in (("bursty", bursty, (12, 3, 2)),
                                  ("bursty", bursty, (30, 7, 2)),
                                  ("self-loops", loops, (40, 5, 2))):
        plan = tzp.plan_zones(g, delta=d, l_max=lm, omega=om)
        lay = tzp.build_zone_layout(g, plan)
        for bounds in ("full", "live"):
            fl = tzp.concat_layout(lay, blk=512, delta=d, l_max=lm,
                                   bounds=bounds)
            check_scan(f"{gname} delta={d} l_max={lm}", fl, delta=d,
                       l_max=lm)

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
    args, code, length, err = check_scan("full-size", fl, delta=d, l_max=lm)
    kernel_ms = cuda_ms(lambda: ops.launch_kernel(
        *args, delta=d, l_max=lm, blk=fl.blk), reps=KERNEL_REPS)
    plain_ms = cuda_ms(lambda: ref.fused_zone_scan_torch(
        *args, delta=d, l_max=lm, blk=fl.blk))
    steps = ref.live_steps(*args, delta=d, l_max=lm, blk=fl.blk)

    bw = copy_bandwidth()
    int_rate = props.multi_processor_count * 64 * sm_clock_mhz * 1e6
    limbs = code.shape[1]
    kbytes = (5 * 4 * fl.n_slots + 2 * 4 * fl.n_blocks
              + (limbs + 1) * 4 * fl.n_slots)
    ops_per_step = OPS_FIXED + OPS_PER_NODE * (lm + 1)
    bytes_ms = kbytes / bw * 1e3
    ops_ms = steps * ops_per_step / int_rate * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    log(f"[full-size] kernel {kernel_ms:.4f} ms (mean of {KERNEL_REPS}), "
        f"plain {plain_ms:.1f} ms")
    log(f"[bound] live steps {steps} x {ops_per_step} int ops / "
        f"{int_rate / 1e12:.2f} Tops/s = {ops_ms:.4f} ms; {kbytes} bytes / "
        f"{bw / 1e9:.0f} GB/s measured copy = {bytes_ms:.4f} ms; bound "
        f"{bound_ms:.4f} ms by {bound_by}; kernel at "
        f"{bound_ms / kernel_ms:.1%} of it")
    del args

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

    # -- 5. main path ---------------------------------------------------
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
    fold = lambda: fold_fused(code, length, sign, fold_chunk=fold_chunk,
                              merge_cap=merge_cap)
    fold()
    fold_ms = cuda_ms(fold, reps=3)
    log(f"[main] fold {fold_ms:.3f} ms (mean of 3; fold_chunk {fold_chunk}, "
        f"merge_cap {merge_cap})")
    del code, length, sign

    # device busy share of one warm discover, from the profiler's trace
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.discover(graph)
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
        top = sorted(by_name.items(), key=lambda r: -r[1])[:6]
        log(f"[main] profiled warm discover: wall {wall_ms:.3f} ms, device "
            f"busy {busy_ms:.3f} ms ({busy_ms / wall_ms:.1%}), idle "
            f"{1 - busy_ms / wall_ms:.1%}; top device time: " + "; ".join(
                f"{k[:60]} {ms:.3f} ms" for k, ms in top))
    else:
        log("[main] profiler recorded no device time: busy share not "
            "measured")

    ops.launches = 0
    times = []
    for _ in range(TIMED_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = engine.discover(graph)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if res.counts != warm.counts:
            raise SystemExit("timed run disagrees with the warm-up")
    launches = ops.launches
    path = res.layout["execution"]["path"]
    if launches < TIMED_RUNS or path != "fused":
        raise SystemExit(f"main path did not go through the kernel: "
                         f"{launches} launches, path {path!r}")
    counts = np.asarray(list(res.counts.values()))
    if not (len(counts) and np.all(counts > 0)):
        raise SystemExit("main path produced no positive counts")
    if res.total_processes() != graph.n_edges:
        raise SystemExit("every edge seeds exactly one process, but "
                         f"{res.total_processes()} != {graph.n_edges}")
    for i, dt in enumerate(times):
        log(f"[main] run {i}: {dt * 1e3:.3f} ms, "
            f"{graph.n_edges / dt:.0f} edges/s")
    log(f"[main] {smi}: edges/s best {graph.n_edges / min(times):.0f}, "
        f"kernel {kernel_ms:.4f} ms, fold {fold_ms:.3f} ms, launches "
        f"{launches} in {TIMED_RUNS} runs, path {path}, "
        f"{len(res.counts)} unique codes, {res.total_processes()} processes")

    # -- 6. kernels -----------------------------------------------------
    kernels = [{
        "name": "fused_zone_scan_flat",
        "route": "cuda",
        "source": "src/repro_torch/kernels/zone_scan/csrc/fused_zone_scan.cu",
        "replaces": "src/repro/kernels/zone_scan/zone_scan.py:429",
        "launches": launches,
        "max_abs_err": err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]
    log(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
