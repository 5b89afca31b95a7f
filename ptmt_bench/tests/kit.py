"""Helpers of the benchmark's CPU tests: tiny copies of the configurations
and a run of ``run.py`` in a fresh process on the CPU.

A run goes to a subprocess because ``run.py`` refuses to report from a
process that has loaded JAX, and a test worker may have (the repo's other
tests import it).
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

from ptmt_bench.registry import CHECKOUT, ROOT

#: the tiny sizes: the same generator and planner at a density whose zones
#: fit rows of 128 slots, a smaller block, and a control scaled to still
#: break its guarantee
TINY = {
    "ptmt-mining": {"generator": {"n_edges": 3000, "rate": 0.01},
                    "shape": {"n_zones": 8, "e_cap": 128},
                    "mining": {"out_cap": 1024},
                    "control": {"mining": {"out_cap": 64}}},
}


def write_tiny(root: Path, bench: dict | None = None) -> Path:
    """Tiny copies of the configurations under ``root/configs``, which a
    registry searching ``root`` first finds in place of the real ones,
    and ``root/BENCHMARK.json`` (``bench``, by default the committed
    one)."""
    from ptmt_bench.control import merged

    (root / "configs").mkdir(parents=True, exist_ok=True)
    for name, over in TINY.items():
        config = json.loads((ROOT / "configs" / f"{name}.json").read_text())
        (root / "configs" / f"{name}.json").write_text(
            json.dumps(merged(config, over)))
    if bench is None:
        bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


DRIVER = """
import sys
sys.path[:0] = [{checkout!r}, {src!r}]
import torch
torch.set_num_threads(1)
from ptmt_bench.registry import Registry, ROOT
from ptmt_bench.tests import faults
reg = Registry(roots=[{root!r}, ROOT],
               benchmark={root!r} + "/BENCHMARK.json")
faults.plant({fault!r})
if {control!r}:
    faults.control(reg)
from ptmt_bench import run
sys.exit(run.main({argv!r}, registry=reg, device="cpu"))
"""


def run_cpu(root: Path, workload: str, *, seed: int = 2**31 + 7,
            fault: str | None = None, control: bool = False,
            timeout: float = 240):
    """``run.py`` on the CPU at the tiny sizes under ``root``; returns
    ``(exit code, last stdout line parsed or None, stderr)``."""
    argv = ["--workload", workload, "--seed", str(seed), "--seconds", "0.2",
            "--trace", "0"]
    code = DRIVER.format(checkout=str(CHECKOUT), src=str(CHECKOUT / "src"),
                         root=str(root), fault=fault, control=control,
                         argv=argv)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=timeout, cwd=str(CHECKOUT))
    lines = proc.stdout.strip().splitlines()
    last = json.loads(lines[-1]) if proc.returncode == 0 and lines else None
    return proc.returncode, last, proc.stderr


#: a later cell's pieces, each in a file of its own: a generator, a traffic
#: driver, a configuration, a traffic mix and a metric reader
EXTRA_GENERATOR = '''
import numpy as np


def generate(*, seed, n_edges, n_nodes, gap):
    """A ring walked edge by edge, node labels permuted by the seed."""
    label = np.random.default_rng(seed).permutation(n_nodes)
    i = np.arange(n_edges)
    return (label[i % n_nodes].astype(np.int32),
            label[(i + 1) % n_nodes].astype(np.int32),
            (i * gap).astype(np.int32), n_nodes)
'''
EXTRA_DRIVER = '''
import time

from ptmt_bench.window import Sample, Window


def warm(session, traffic):
    session.call()


def run_window(session, traffic, *, seconds, seed):
    """Calls at a fixed rate, each at its arrival time or as soon as the
    last one returns."""
    every = 1.0 / traffic["calls_per_s"]
    sample = Sample(traffic["check_sample"], seed)
    spans, n, work = [], 0, 0.0
    t0 = time.perf_counter()
    while t0 + n * every < t0 + seconds:
        arrival = t0 + n * every
        time.sleep(max(0.0, arrival - time.perf_counter()))
        sample.offer(n, session.call())
        spans.append(("ptmt_bench.call", arrival, time.perf_counter()))
        work += session.work_per_call
        n += 1
    return Window(t0=t0, t1=time.perf_counter(), attempted=n, failed=0,
                  work=work, kept=sample.kept, spans=spans)
'''
EXTRA_METRIC = '''
def read(record):
    return record.calls / record.window_s
'''


def write_extra(root: Path) -> dict:
    """A later cell ``ring.paced`` dropped in under ``root`` as new files
    only, with a new generator and a new traffic driver; returns the
    ``BENCHMARK.json`` that lists it beside the committed cells."""
    from ptmt_bench.control import merged

    for sub, name, text in (("data", "ring_stream.py", EXTRA_GENERATOR),
                            ("drivers", "paced_loop.py", EXTRA_DRIVER),
                            ("metrics", "calls_per_s.py", EXTRA_METRIC)):
        (root / sub).mkdir(parents=True, exist_ok=True)
        (root / sub / name).write_text(text)
    base = json.loads((ROOT / "configs" / "ptmt-mining.json").read_text())
    config = merged(base, TINY["ptmt-mining"])
    config["name"] = "ring"
    config["generator"] = {"name": "ring_stream", "n_edges": 4000,
                           "n_nodes": 50, "gap": 90}
    (root / "configs").mkdir(parents=True, exist_ok=True)
    (root / "configs" / "ring.json").write_text(json.dumps(config))
    (root / "traffic").mkdir(parents=True, exist_ok=True)
    (root / "traffic" / "paced.json").write_text(json.dumps(
        {"name": "paced", "driver": "paced_loop", "calls_per_s": 20,
         "check_sample": 2}))
    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "ring", "source": "a ring",
                             "file": "ptmt_bench/configs/ring.json",
                             "reduced": [], "why": "a later cell"})
    bench["workloads"].append({"name": "ring.paced", "config": "ring",
                               "traffic": "paced", "chips": 1,
                               "why": "a later cell"})
    for m in bench["end_to_end"]:
        if m["name"] == "mine_edges_per_s":
            m["workloads"].append("ring.paced")
    bench["per_layer"].append({"name": "calls_per_s", "unit": "1/s",
                               "better": "higher", "source": "host_clock",
                               "layer": "traffic",
                               "moves": "mine_edges_per_s",
                               "workloads": ["ring.paced"]})
    return bench
