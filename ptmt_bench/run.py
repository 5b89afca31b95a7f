"""Run one cell of the benchmark and print its result as the last line.

    python3 ptmt_bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

One process per run: set-up (inputs from the seed, the program's entry,
warm-up calls), the measured window, then the comparison with the plain
reference, then one JSON line.  ``--trace 0`` reports the cell's
end-to-end metrics; ``--trace 1`` runs the window under ``torch.profiler``
with the program's spans on and reports its per-layer metrics.  See
``ptmt_bench/README.md``.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

#: top-level module names that may not be loaded in a run's process: the
#: JAX stack and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def cache_bytecode() -> None:
    """Keep the bytecode of every module the run imports in a fixed
    directory inside the checkout, as the kernels are kept: where the
    environment turns bytecode writing off (``PYTHONDONTWRITEBYTECODE``)
    and the installed packages ship none, every process compiles torch's
    Python sources again, ~5.6 s of set-up on the card's host.  Only the
    first run in a checkout writes it."""
    sys.dont_write_bytecode = False
    sys.pycache_prefix = str(CHECKOUT / "build" / "ptmt_bench_cache"
                             / "pycache")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), required=True)
    return ap.parse_args(argv)


def card(chips: int) -> str:
    """The device a run measures on; exits when the machine has fewer
    cards than the cell asks for."""
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this benchmark measures the card")
    if torch.cuda.device_count() < chips:
        sys.exit(f"the cell needs {chips} card(s), the machine has "
                 f"{torch.cuda.device_count()}")
    return "cuda:0"


def describe(device, chips: int) -> dict:
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": dev.type, "kind": dev.type, "count": chips,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}


def main(argv=None, *, registry=None, device=None) -> int:
    """One run; returns its exit code.  ``device`` is set by the tests
    only (they run the CPU through everything but the card check)."""
    args = parse(argv)
    cache_bytecode()
    # the program's build directory is fixed inside the checkout
    # (build/repro_torch_kernels); give any other compiler cache one too
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(CHECKOUT / "build" / "ptmt_bench_cache" / sub)
    src = str(CHECKOUT / "src")
    if src not in sys.path:
        sys.path.insert(1, src)

    from ptmt_bench import window as win
    from ptmt_bench.registry import Registry
    from ptmt_bench.trace import DeviceTrace, Record

    reg = registry or Registry()
    cell = reg.cell(args.workload)
    config = reg.config(cell["config"])
    traffic = reg.traffic(cell["traffic"])
    driver = reg.driver(traffic["driver"])
    import torch  # noqa: F401

    stages = {"torch_s": time.perf_counter() - T_START}
    if device is None:
        device = card(cell["chips"])
    stages["card_s"] = time.perf_counter() - T_START - stages["torch_s"]
    import repro_torch  # noqa: F401  (fails where only the benchmark is)

    seed = args.seed % (1 << 63)
    session = reg.session(config, seed=seed, device=device,
                          traced=bool(args.trace))
    stages["imports_s"] = time.perf_counter() - T_START
    session.setup()
    stages["build_s"] = time.perf_counter() - T_START - stages["imports_s"]
    driver.warm(session, traffic)
    sync(device)
    setup_s = time.perf_counter() - T_START
    stages["warm_s"] = setup_s - stages["imports_s"] - stages["build_s"]

    trace = DeviceTrace(device) if args.trace else None
    host0 = win.host_sample()
    if trace is not None:
        with trace:
            window = driver.run_window(session, traffic,
                                       seconds=args.seconds, seed=seed)
    else:
        window = driver.run_window(session, traffic, seconds=args.seconds,
                                   seed=seed)
    host = win.host_delta(host0, win.host_sample())
    calls = sorted(b - a for _, a, b in window.spans)
    if calls:
        host["call_s"] = [calls[0], calls[len(calls) // 2], calls[-1]]
    dev_info = describe(device, cell["chips"])
    found = forbidden_modules()
    if found:
        print(f"modules loaded that the benchmark forbids: {found}",
              file=sys.stderr)
        return 3

    spans = session.spans() + window.spans
    session.free()
    t_check = time.perf_counter()
    numbers, info, context = session.check(window.kept)
    stages["check_s"] = time.perf_counter() - t_check
    limits = config["limits"]
    checks = {name: {"value": numbers[name], "limit": limits[name]}
              for name in limits}
    correct = (window.failed == 0 and window.completed > 0 and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in checks.values()))

    record = Record(t0=window.t0, t1=window.t1, calls=window.completed,
                    work=window.work, spans=spans,
                    device=trace.events if trace else [], context=context,
                    setup_s=setup_s)
    metrics = {}
    for m in reg.metrics_for(cell["name"], trace=bool(args.trace)):
        value = reg.reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if trace is not None:
        dev_info["busy_s"] = record.busy_s()
        dev_info["window_s"] = record.window_s
    result = {"correct": correct, "attempted": window.attempted,
              "failed": window.failed, "metrics": metrics,
              "device": dev_info}
    if trace is not None:
        result["breakdown"] = record.breakdown()
    result["info"] = {**info, "stages": stages, "host": host}
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


if __name__ == "__main__":
    sys.exit(main())
