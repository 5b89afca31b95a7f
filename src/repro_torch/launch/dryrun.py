"""Multi-pod dry run: trace every (arch x shape x mesh) cell on one rank.

For each cell the step runs once, on fake tensors (``FakeTensorMode``: shape
and dtype, no storage, no compute) placed as DTensors by the workload's
shardings on the production mesh (single-pod 16x16 and multi-pod 2x16x16)
of a fake process group of 256 or 512 ranks, as rank 0.  It records:
  * the rank's FLOPs (``FlopCounterMode``'s formulas, on its shards);
  * its collectives by kind with their bytes;
  * its peak memory (every storage its ops make, live until its last
    tensor is freed), split into arguments, outputs and the rest, and
    whether it fits one H100's 80 GB.
The Python layer loop runs every layer, so no scan calibration is needed
(``scan_calibrated`` is false and ``flops_per_chip == flops_per_chip_raw``).
The GNN, equiformer and DCN-v2 steps reach the B4 and B5 kernels through
their ``torch.library`` custom ops: the fake tensors (on the CPU, as for
every cell: a custom op's fake implementation gives its shapes on any
device) run their fake implementations, and the counter counts them by
their FLOP formulas.  A mining cell is not traced (its kernel is a ctypes
call): its ops and bytes come from ``configs.ptmt.analytic_mining_terms``
and its memory from the executor's own model
(``configs.ptmt.mining_rank_bytes``).

Results are cached as one JSON per cell under --out; reruns skip finished
cells.  ``--orchestrate`` runs every remaining cell in a fresh subprocess
(one fake world per process; one failing cell cannot kill the sweep).

Usage:
  python -m repro_torch.launch.dryrun --arch granite-8b --shape train_4k \
      --mesh single
  python -m repro_torch.launch.dryrun --arch granite-8b --shape train_4k \
      --mesh-shape 1 --n-layers 1    # the same step unsharded, 1 layer
  python -m repro_torch.launch.dryrun --orchestrate --jobs 4 # full sweep
  python -m repro_torch.launch.dryrun --orchestrate --n-layers 2 --tag l2
      # every cell at 2 layers (--override and --tag apply to each cell)
  python -m repro_torch.launch.dryrun --report               # print the table
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import math
import os
import subprocess
import sys
import tempfile
import time
import traceback

DEFAULT_OUT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))), "build", "dryrun")

#: the mesh axes of a test mesh, by its rank count (the last of these)
_AXES = ("pod", "data", "model")


def cell_path(out_dir, arch, shape, mesh_kind, tag=""):
    safe = lambda s: s.replace("/", "_")  # noqa: E731
    suffix = f"__{tag}" if tag else ""
    return os.path.join(
        out_dir, f"{safe(arch)}__{safe(shape)}__{mesh_kind}{suffix}.json"
    )


def _apply_overrides(arch, overrides: str):
    if not overrides:
        return arch
    kv = {}
    for part in overrides.split(","):
        key, val = part.split("=", 1)
        field_type = type(getattr(arch.config, key))
        kv[key] = field_type(val) if field_type is not bool else (
            val.lower() in ("1", "true", "yes"))
    return dataclasses.replace(
        arch, config=dataclasses.replace(arch.config, **kv))


def decode_position(shape) -> int:
    """The ``cache_len`` a decode cell's step runs at: the middle of the
    cache (the JAX dry run traces it symbolically; a step's work does not
    depend on it)."""
    return shape.seq_len // 2


def _local(x):
    from torch.distributed.tensor import DTensor

    return x.to_local() if isinstance(x, DTensor) else x


def _local_bytes(tree) -> int:
    from repro_torch.training.tree import leaves
    import torch

    return sum(_local(x).numel() * _local(x).element_size()
               for x in leaves(tree) if isinstance(x, torch.Tensor))


def trace_step(wl, shape, *, device="cpu") -> dict:
    """One call of the workload's step on fake tensors (on ``device``),
    counted: the rank's FLOPs, collectives, op bytes and memory."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import analysis
    from repro_torch.training.tree import leaves

    with FakeTensorMode(allow_non_fake_inputs=True):
        args = local_args(wl, shape, lambda dims, dtype: torch.empty(
            dims, dtype=dtype, device=device))
        counter = analysis.RankCounter(track_memory=True)
        counter.hold(*(_local(x) for x in leaves(args)
                       if isinstance(x, torch.Tensor)))
        arg_bytes = counter.live_bytes
        t0 = time.perf_counter()
        with counter:
            out = wl.fn(*args)
        seconds = time.perf_counter() - t0
        out_bytes = _local_bytes(out)
    return {"flops": counter.flops, "op_bytes": counter.op_bytes,
            "coll": analysis.collective_bytes(counter.collectives),
            "peak_bytes": counter.peak_bytes, "argument_bytes": arg_bytes,
            "output_bytes": out_bytes, "seconds": seconds}


def local_args(wl, shape, make):
    """The step's arguments, each DTensor made from this rank's shard
    alone (``make(dims, dtype)``; no global tensor is allocated) by the
    workload's shardings; a decode step's ``cache_len`` is a host int."""
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.models import sharding as shd
    from repro_torch.training.tree import leaves, unflatten

    def place(meta, sharding):
        if sharding is None or sharding.mesh.size() == 1:
            return make(list(meta.shape), meta.dtype)
        dims = [shd._chunk(sharding.mesh, sharding.placements, d, n)[1]
                for d, n in enumerate(meta.shape)]
        return DTensor.from_local(
            make(dims, meta.dtype), sharding.mesh, sharding.placements,
            run_check=False, shape=meta.shape,
            stride=torch.empty(meta.shape, device="meta").stride())

    shardings = wl.in_shardings or (None,) * len(wl.in_sds)
    args = []
    for a, sh in zip(wl.in_sds, shardings, strict=True):
        flat = leaves(sh) if sh is not None else [None] * len(leaves(a))
        args.append(unflatten(a, [place(m, s) for m, s in zip(
            leaves(a), flat, strict=True)]))
    if wl.kind == "decode":
        args[3] = decode_position(shape)
    return args


def run_real(arch_name: str, shape_name: str, *,
             n_layers: int | None = 2, device: str = "cuda") -> dict:
    """One cell at ``n_layers`` layers (``None``, or a config without
    layers: whole) run for real as rank 0 of the single-pod production
    mesh on a fake world: real tensors on ``device``, each rank-sized and
    drawn from seed 0, whose collectives move nothing (so the values mean
    nothing).  Returns the rank's FLOPs (counted as :func:`trace_step`
    counts them), ms of a step after a warm-up, the kernels' launch
    counts of that step, and on CUDA the step's peak memory: its
    ``max_memory_allocated`` less what stays allocated before the step
    apart from its arguments (``held_bytes``: cuBLAS's workspace, made in
    the warm-up), so the arguments and what the step allocates, as the
    dry run counts them."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.launch import analysis, mesh as mesh_lib

    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    dims, axes = mesh_lib.production_shape(False)
    mesh_lib.fake_world(math.prod(dims))
    try:
        mesh = mesh_lib.make_test_mesh(dims, axes,
                                       device_type=torch.device(device).type)
        arch = get_arch(arch_name)
        wl = None if n_layers is None else arch.workload_with_depth(
            shape_name, mesh, n_layers)
        if wl is None:
            wl = arch.workload(shape_name, mesh)
        gen = torch.Generator(device=device).manual_seed(0)
        on_cuda = torch.device(device).type == "cuda"
        sync = torch.cuda.synchronize if on_cuda else (lambda: None)

        def make(dims, dtype):
            # floats drawn from the seed (x 0.02); integers 0: a valid
            # token, a step counter, node 0; masks on
            if dtype.is_floating_point:
                return (torch.randn(dims, generator=gen, device=device)
                        * 0.02).to(dtype)
            if dtype == torch.bool:
                return torch.ones(dims, dtype=dtype, device=device)
            return torch.zeros(dims, dtype=dtype, device=device)

        args = local_args(wl, arch.shape(shape_name), make)
        wl.fn(*args)                                        # warm-up
        sync()
        held = None
        if on_cuda:
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated() - _local_bytes(args)
        counter = analysis.RankCounter()
        for ops in _kernel_ops():
            ops.reset_launches()
        t0 = time.perf_counter()
        with counter:
            wl.fn(*args)
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() - held if on_cuda \
            else None
        launches = {k: v for ops in _kernel_ops()
                    for k, v in ops.launches.items() if v}
    finally:
        dist.destroy_process_group()
    return {"flops": counter.flops, "ms": ms, "peak_bytes": peak,
            "held_bytes": held, "collectives": len(counter.collectives),
            "launches": launches}


def _kernel_ops():
    from repro_torch.kernels.embedding_bag import ops as bag_ops
    from repro_torch.kernels.segment_spmm import ops as spmm_ops

    return spmm_ops, bag_ops


def _mining_record(arch, shape, n_chips: int) -> dict:
    from repro_torch.configs.ptmt import analytic_mining_terms, \
        mining_rank_bytes
    from repro_torch.core import encoding
    from repro_torch.launch import analysis

    cfg = arch.config
    terms = analytic_mining_terms(cfg, shape, n_chips)
    mem = mining_rank_bytes(cfg, shape, n_chips)
    # the flat merge: an all-gather of each rank's <= out_cap code rows
    # and counts, and the summed overflow flag
    rows = min(cfg.out_cap, max(shape.n_zones // n_chips, 1) * shape.e_cap)
    gathered = n_chips * rows * 4 * (encoding.n_limbs(cfg.l_max) + 1)
    coll = analysis.collective_bytes(
        [("all-gather", gathered), ("all-reduce", 4)])
    return {"flops": terms["ops_per_chip"], "op_bytes": 0.0, "coll": coll,
            "peak_bytes": sum(mem.values()),
            "argument_bytes": mem["argument_bytes"],
            "output_bytes": mem["output_bytes"], "seconds": 0.0,
            "hbm_bytes": terms["hbm_bytes_per_chip"]}


def run_cell(arch_name: str, shape_name: str, mesh_kind: str,
             out_dir: str, overrides: str = "", tag: str = "", *,
             n_layers: int | None = None, shape=None, smoke: bool = False,
             mesh_shape=None) -> dict:
    """Trace one cell and write its record.  ``n_layers`` cuts the full
    config's depth (``workload_with_depth``; a config without layers runs
    whole); ``shape`` replaces the registry's shape of that name, ``smoke``
    takes the smoke config and ``mesh_shape`` a test mesh (the last axes
    of pod, data, model; ``(1,)`` runs the step unsharded), as the tests
    do.  Makes a fake world of the mesh's ranks when the process has
    no process group, and destroys it after."""
    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.launch import analysis, mesh as mesh_lib

    # DTensor warns of every redistribution over two mesh dimensions
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    if mesh_shape is not None:
        dims, axes = tuple(mesh_shape), _AXES[-len(mesh_shape):]
    else:
        dims, axes = mesh_lib.production_shape(mesh_kind == "multi")
    n_chips = math.prod(dims)
    made = not dist.is_initialized()
    if made:
        mesh_lib.fake_world(n_chips)
    try:
        mesh = mesh_lib.make_test_mesh(dims, axes)
        arch = _apply_overrides(get_arch(arch_name), overrides)
        shape = shape or arch.shape(shape_name)
        cfg = arch.smoke_config if smoke else arch.config
        t0 = time.perf_counter()
        wl = None
        if n_layers is not None:
            wl = arch.workload_with_depth(shape_name, mesh, n_layers)
        if wl is None:           # no depth to cut: DCN-v2, mining
            n_layers = None
            wl = arch.workload_fn(cfg, shape, mesh)
        if arch.family == "mining":
            m = _mining_record(arch, shape, n_chips)
            peak_flops = analysis.INT_PEAK
        else:
            m = trace_step(wl, shape)
            peak_flops = analysis.PEAK_FLOPS
        trace_s = time.perf_counter() - t0
    finally:
        if made:
            dist.destroy_process_group()

    temp = max(m["peak_bytes"] - m["argument_bytes"] - m["output_bytes"], 0)
    # roofline memory term: unique bytes touched (args + temps + outputs);
    # the ops' own reads and writes are kept as an upper bound
    mem_traffic = m["argument_bytes"] + m["output_bytes"] + temp
    if arch.family == "mining":
        mem_traffic = max(mem_traffic, m["hbm_bytes"])
    record = {
        "arch": arch_name,
        "shape": shape.name,
        "mesh": mesh_kind,
        "n_chips": n_chips,
        "kind": wl.kind,
        "model_flops": wl.model_flops,
        "peak_flops": peak_flops,
        "flops_per_chip": float(m["flops"]),
        "bytes_per_chip": float(mem_traffic),
        "hlo_bytes_per_chip_upper": float(m["op_bytes"]),
        "flops_per_chip_raw": float(m["flops"]),
        "collective_bytes_per_chip": m["coll"]["total_bytes"],
        "collectives": m["coll"]["per_kind_counts"],
        "collective_bytes_by_kind": m["coll"]["per_kind_bytes"],
        "scan_calibrated": False,
        "memory": {
            "argument_bytes": m["argument_bytes"],
            "output_bytes": m["output_bytes"],
            "temp_bytes": temp,
            "alias_bytes": 0,
        },
        "peak_bytes_per_chip": m["peak_bytes"],
        "fits_h100": analysis.fits(m["peak_bytes"]),
        "n_layers": n_layers or getattr(cfg, "n_layers", None),
        "compile_s": trace_s,
        "overrides": overrides,
        "tag": tag,
        "status": "ok",
    }
    record.update(analysis.roofline(record))
    os.makedirs(out_dir, exist_ok=True)
    with open(cell_path(out_dir, arch_name, shape.name, mesh_kind, tag),
              "w") as f:
        json.dump(record, f, indent=1)
    return record


def _cell_cmd(a, s, m, out_dir, overrides, tag, n_layers):
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", a,
           "--shape", s, "--mesh", m, "--out", out_dir]
    if overrides:
        cmd += ["--override", overrides]
    if tag:
        cmd += ["--tag", tag]
    if n_layers is not None:
        cmd += ["--n-layers", str(n_layers)]
    return cmd


def orchestrate(out_dir: str, meshes=("single", "multi"), force=False,
                only_arch=None, timeout=3600, cells=None, jobs: int = 1,
                overrides: str = "", tag: str = "",
                n_layers: int | None = None):
    """Run every remaining cell (or ``cells``, ``(arch, shape, mesh)``
    triples) in a subprocess of its own, ``jobs`` at a time, each with
    ``overrides``, ``tag`` and ``n_layers`` as ``run_cell`` takes them; a
    failed cell writes an ``"error"`` record with the end of its stderr.
    Returns the failed cells in ``cells``' order."""
    from repro_torch.configs import all_cells

    if cells is None:
        cells = [
            (a, s, m) for (a, s) in all_cells() for m in meshes
            if only_arch is None or a == only_arch
        ]
    todo = []
    for a, s, m in cells:
        path = cell_path(out_dir, a, s, m, tag)
        if not force and os.path.exists(path):
            with open(path) as f:
                if json.load(f).get("status") == "ok":
                    continue
        todo.append((a, s, m))
    print(f"dry-run sweep: {len(todo)} cells to run "
          f"({len(cells) - len(todo)} cached)", flush=True)
    env = dict(os.environ)
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    failures = []
    running = []
    pending = list(enumerate(todo))

    def finish(i, cell, proc, t0, errfile):
        a, s, m = cell
        proc.wait()
        dt = time.perf_counter() - t0
        errfile.seek(0)
        err = errfile.read()
        errfile.close()
        if proc.returncode != 0:
            failures.append((i, cell))
            err = (err or "")[-1500:]
            os.makedirs(out_dir, exist_ok=True)
            with open(cell_path(out_dir, a, s, m, tag), "w") as f:
                json.dump({"arch": a, "shape": s, "mesh": m,
                           "status": "error", "stderr": err}, f, indent=1)
            print(f"[{i+1}/{len(todo)}] FAIL {a}/{s}/{m} ({dt:.0f}s)")
            print(err.splitlines()[-3:] if err else "", flush=True)
        else:
            print(f"[{i+1}/{len(todo)}] ok   {a}/{s}/{m} ({dt:.0f}s)",
                  flush=True)

    while pending or running:
        while pending and len(running) < jobs:
            i, cell = pending.pop(0)
            # stderr to a file: a pipe left unread could fill and stall it
            err = tempfile.TemporaryFile("w+")
            proc = subprocess.Popen(
                _cell_cmd(*cell, out_dir, overrides, tag, n_layers),
                stdout=subprocess.DEVNULL, stderr=err, text=True, env=env)
            running.append((i, cell, proc, time.perf_counter(), err))
        time.sleep(0.2)
        for item in list(running):
            i, cell, proc, t0, err = item
            if proc.poll() is None and time.perf_counter() - t0 < timeout:
                continue
            if proc.poll() is None:
                proc.kill()
                proc.wait()
                err.write(f"\ntimed out after {timeout}s")
            running.remove(item)
            finish(i, cell, proc, t0, err)
    failures = [cell for _, cell in sorted(failures)]
    print(f"done; {len(failures)} failures: {failures}")
    return failures


def report(out_dir: str):
    rows = []
    for fn in sorted(os.listdir(out_dir)):
        if not fn.endswith(".json"):
            continue
        with open(os.path.join(out_dir, fn)) as f:
            rows.append(json.load(f))
    hdr = (f"{'arch':22s} {'shape':15s} {'mesh':6s} {'status':6s} "
           f"{'TFLOP':>9s} {'GB':>8s} {'coll_GB':>8s} "
           f"{'comp_ms':>9s} {'mem_ms':>8s} {'coll_ms':>8s} {'dom':>10s} "
           f"{'useful':>7s} {'peak_GB':>8s} {'fits':>5s}")
    print(hdr)
    print("-" * len(hdr))
    for r in rows:
        if r.get("status") != "ok":
            print(f"{r['arch']:22s} {r['shape']:15s} {r['mesh']:6s} ERROR")
            continue
        print(
            f"{r['arch']:22s} {r['shape']:15s} {r['mesh']:6s} "
            f"{r['status']:6s} {r['flops_per_chip'] / 1e12:9.3f} "
            f"{r['bytes_per_chip'] / 1e9:8.2f} "
            f"{r['collective_bytes_per_chip'] / 1e9:8.3f} "
            f"{r['compute_s']*1e3:9.2f} {r['memory_s']*1e3:8.2f} "
            f"{r['collective_s']*1e3:8.2f} {r['dominant']:>10s} "
            f"{r['useful_flops_ratio']:7.3f} "
            f"{r['peak_bytes_per_chip'] / 1e9:8.2f} "
            f"{'yes' if r['fits_h100'] else 'no':>5s}"
        )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--orchestrate", action="store_true")
    ap.add_argument("--report", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--only-arch")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once by --orchestrate")
    ap.add_argument("--override", default="",
                    help="config overrides, e.g. gather_dtype=bf16")
    ap.add_argument("--tag", default="",
                    help="result-file suffix for optimized variants")
    ap.add_argument("--n-layers", type=int,
                    help="cut the config's depth (workload_with_depth)")
    ap.add_argument("--mesh-shape",
                    help="one cell on a test mesh in place of --mesh's, "
                         "e.g. 1 (the step unsharded) or 2,2")
    args = ap.parse_args()

    if args.report:
        report(args.out)
        return
    if args.orchestrate:
        failures = orchestrate(args.out, force=args.force,
                               only_arch=args.only_arch, jobs=args.jobs,
                               overrides=args.override, tag=args.tag,
                               n_layers=args.n_layers)
        sys.exit(1 if failures else 0)
    if not (args.arch and args.shape):
        ap.error("--arch and --shape required (or --orchestrate/--report)")
    mesh_kind, mesh_shape = args.mesh, None
    if args.mesh_shape:
        mesh_shape = tuple(int(n) for n in args.mesh_shape.split(","))
        mesh_kind = "x".join(map(str, mesh_shape))
    try:
        rec = run_cell(args.arch, args.shape, mesh_kind, args.out,
                       overrides=args.override, tag=args.tag,
                       n_layers=args.n_layers, mesh_shape=mesh_shape)
    except Exception:
        traceback.print_exc()
        sys.exit(1)
    print(json.dumps(
        {k: rec[k] for k in
         ("arch", "shape", "mesh", "compute_s", "memory_s", "collective_s",
          "dominant", "useful_flops_ratio", "roofline_fraction",
          "compile_s")},
        indent=1,
    ))
    print("memory:", rec["memory"], "peak:", rec["peak_bytes_per_chip"],
          "fits_h100:", rec["fits_h100"])
    print("collectives:", rec["collectives"])


if __name__ == "__main__":
    main()
