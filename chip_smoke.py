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
   bucket; the dense kernel is timed on every bucket);
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
8. one JSON line naming every kernel with its launches, error and times;
9. last line: ``{"ok": true, "device": {...}}``.

Every path of phases 5-7 runs with the kernels' launch counts set to 0
just before it and read just after; a kernel its path should launch but
did not fails the run.  It exits non-zero, with no result line, when any
phase fails or when PyTorch sees no CUDA device.
"""

from __future__ import annotations

import json
import os
import re
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


def report_registers(logs: dict) -> None:
    """Registers of each kernel instantiation by ``l_max``, from ``ptxas
    -v``, and whether any instantiation spills."""
    spills = []
    for src, text in logs.items():
        rows = []
        # one block per entry function, whatever order ptxas reports in
        for block in text.split("Compiling entry function '")[1:]:
            name = block.split("'", 1)[0]
            inst = re.search(r"ILi(\d+)ELb([01])E", name)
            regs = re.search(r"Used (\d+) registers", block)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                              r"spill loads", block)
            if not (inst and regs and spill):
                log(f"[build] {src}: no register report read for {name}")
                continue
            rows.append((int(inst.group(1)), int(inst.group(2)),
                         int(regs.group(1))))
            if int(spill.group(1)) or int(spill.group(2)):
                spills.append(name)
        rows.sort()
        for ts in (0, 1):
            log(f"[build] {src} with_ts={ts}: registers by l_max "
                + ", ".join(f"{lm}:{r}" for lm, t, r in rows if t == ts))
    log(f"[build] spills: {spills if spills else 'none'}")


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


def dense_live_steps(args, *, delta, l_max) -> int:
    """Slots the dense kernel's lanes visit on one ``[Z, E]`` batch: the
    flat sweep's count on the same rows laid end to end, one block per
    row (the two kernels share the row sweep)."""
    import torch
    from repro_torch.kernels.zone_scan import ref

    z, e = args[0].shape
    rows = torch.arange(z, dtype=torch.int32, device=DEVICE)
    zone_id = rows.repeat_interleave(e)
    return ref.live_steps(
        *(x.reshape(-1) for x in args), zone_id, rows * e, (rows + 1) * e,
        delta=delta, l_max=l_max, blk=e)


def run_counted(label, fn, expect):
    """Run one path with every launch count at 0 before and read after;
    fails when a kernel in ``expect`` ran no launch (or, where ``expect``
    gives a number, another number of launches)."""
    import torch
    from repro_torch.kernels.zone_scan import ops

    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(ops.launches)
    for name, n in expect.items():
        if counts[name] == 0 or (n is not None and counts[name] != n):
            raise SystemExit(f"{label}: {name} launched {counts[name]} "
                             f"time(s), expected {n or 'some'}")
    log(f"[{label}] {dt:.3f}s, launches "
        + ", ".join(f"{k} {v}" for k, v in counts.items() if v))
    return res, dt, counts


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
    bw = copy_bandwidth()
    int_rate = props.multi_processor_count * 64 * sm_clock_mhz * 1e6
    log(f"[bound] integer rate {props.multi_processor_count} SMs x 64 x "
        f"{sm_clock_mhz:.0f} MHz = {int_rate / 1e12:.2f} Tops/s; measured "
        f"copy rate {bw / 1e9:.0f} GB/s")

    def bound(name, n_bytes, n_ops, ms):
        bytes_ms = n_bytes / bw * 1e3
        ops_ms = n_ops / int_rate * 1e3
        b_ms = max(bytes_ms, ops_ms)
        by = "bytes" if bytes_ms >= ops_ms else "operations"
        log(f"[bound] {name}: {n_ops} int ops = {ops_ms:.4f} ms; {n_bytes} "
            f"bytes = {bytes_ms:.4f} ms; bound {b_ms:.4f} ms by {by}; "
            f"kernel {ms:.4f} ms, at {b_ms / ms:.1%} of its bound")
        return b_ms, by

    timing = {}
    # flat kernel, both variants, on the full-size stream
    steps = None
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
            steps = ref.live_steps(*args, delta=d, l_max=lm, blk=fl.blk)
        n_bytes = (5 * 4 * fl.n_slots + 2 * 4 * fl.n_blocks
                   + (limbs + 1 + (lm if with_ts else 0)) * 4 * fl.n_slots)
        n_ops = steps * (OPS_FIXED + OPS_PER_NODE * (lm + 1))
        timing[name] = (ms, plain_ms, *bound(name, n_bytes, n_ops, ms))
        log(f"[full-size] {name}: kernel {ms:.4f} ms (mean of "
            f"{KERNEL_REPS}), plain {plain_ms:.1f} ms, {steps} live "
            f"lane-slots")
        if not with_ts:
            main_code, main_length = out
    del args, out

    # dense kernel, both variants, timed on every bucket of the same
    # layout; held against its plain version (a per-edge torch loop that
    # takes minutes here) on the largest bucket alone, which is also the
    # shape its JSON entry reports
    largest = max(layout.buckets, key=lambda b: b.u.size)
    total_ms = dict.fromkeys((False, True), 0.0)
    for b in layout.buckets:
        if b is largest:
            args, plain_s, err = check_dense(
                f"full-size bucket {b.label}", b, delta=d, l_max=lm)
        else:
            args = batch_tensors(b, DEVICE)
        n_steps = dense_live_steps(args, delta=d, l_max=lm)
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
    seq_steps = dense_live_steps(seq_args, delta=d, l_max=lm)
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

    # -- 8. kernels -----------------------------------------------------
    rows = (
        ("fused_zone_scan_flat", "fused_zone_scan.cu", ":429", launches),
        ("fused_zone_scan_flat_ts", "fused_zone_scan.cu", ":429 (with_ts)",
         flat_ts_launches),
        ("zone_scan_dense", "zone_scan.cu", ":245", dense_launches),
        ("zone_scan_dense_ts", "zone_scan.cu", ":245 (with_ts)",
         dense_ts_launches),
    )
    kernels = []
    for name, src, line, n in rows:
        ms, plain_ms, bound_ms, bound_by = timing[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": SRC + src,
            "replaces": TPU + line,
            "launches": n,
            "max_abs_err": errs[name],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,
        })
    log(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
