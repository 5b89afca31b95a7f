"""Helpers of the benchmark's CPU tests: tiny copies of the configurations
and a run of ``run.py`` in a fresh process on the CPU.

A run goes to a subprocess because ``run.py`` refuses to report from a
process that has loaded JAX, and a test worker may have (the repo's other
tests import it).

What the tests need of a configuration or an entry beyond what ``run.py``
reads sits in files of its own, found by name in a drop-in root first,
then under ``ptmt_bench/tests``:

* ``tiny/<config>.json``: ``overlay``, the sizes that make the
  configuration run on the CPU in seconds, laid over it key by key, and
  ``control_breaks``, the checks its control has to break;
* ``entry_faults/<entry>.py``: the faults of an entry (``faults.py``).
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

from ptmt_bench.registry import CHECKOUT, ROOT, Registry

TESTS = Path(__file__).resolve().parent


def pieces(root: Path | None = None) -> Registry:
    """Finds the tests' own pieces by name, under a drop-in ``root``
    first, then under ``ptmt_bench/tests``."""
    return Registry(roots=[r for r in (root, TESTS) if r is not None])


def tiny(config: str, root: Path | None = None) -> dict:
    """The tiny overlay file of configuration ``config``; raises, naming
    the file to add, where it has none."""
    try:
        path = pieces(root).find("tiny", config, ".json")
    except FileNotFoundError:
        raise FileNotFoundError(
            f"configuration {config!r} has no tiny overlay: add "
            f"ptmt_bench/tests/tiny/{config}.json"
            + (f" or {root}/tiny/{config}.json" if root else "")
        ) from None
    return json.loads(path.read_text())


def check_keys(over: dict, config: dict, where: str = "") -> None:
    """Every key of an overlay is a key of its configuration, so that a
    misspelt key cannot leave a size at its full value."""
    for key, value in over.items():
        if key not in config:
            raise ValueError(f"tiny overlay key {where + key!r} is not a "
                             "key of the configuration")
        if isinstance(value, dict) and isinstance(config[key], dict):
            check_keys(value, config[key], f"{where}{key}.")


def write_tiny(root: Path, bench: dict | None = None) -> Path:
    """Tiny copies of every configuration of ``bench`` (by default the
    committed ``BENCHMARK.json``) under ``root/configs``, which a registry
    searching ``root`` first finds in place of the real ones, and
    ``root/BENCHMARK.json``.  A configuration is read from ``root`` first
    (a drop-in's), then from the benchmark's own; one without an overlay
    raises, and none is written at its full size."""
    from ptmt_bench.control import merged

    if bench is None:
        bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    reg = Registry(roots=[root, ROOT])
    copies = {}
    for entry in bench["configs"]:
        name = entry["name"]
        config = reg.config(name)
        over = tiny(name, root)["overlay"]
        check_keys(over, config)
        copies[name] = merged(config, over)
    (root / "configs").mkdir(parents=True, exist_ok=True)
    for name, config in copies.items():
        (root / "configs" / f"{name}.json").write_text(json.dumps(config))
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
faults.plant(reg, {workload!r}, {fault!r}, {root!r})
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
                         root=str(root), workload=workload, fault=fault,
                         control=control, argv=argv)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=timeout, cwd=str(CHECKOUT))
    lines = proc.stdout.strip().splitlines()
    last = json.loads(lines[-1]) if proc.returncode == 0 and lines else None
    return proc.returncode, last, proc.stderr


#: a later cell's pieces, each in a file of its own: a generator, a traffic
#: driver, an entry, a configuration, a traffic mix and a metric reader,
#: and for the tests the configuration's tiny overlay and the entry's faults
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
EXTRA_ENTRY = '''
"""Entry ``ring_step``: a later program path; here ``mine_step``'s step
under a name of its own."""
from ptmt_bench.registry import Registry

Session = Registry().entry("mine_step").Session
'''
EXTRA_FAULTS = '''
from ptmt_bench.tests import faults

# ``ring_step`` drives ``mine_step``'s step, so it can have its faults
_step = faults.entry_module("mine_step")
BREAKS = _step.BREAKS
plant = _step.plant
'''
#: the overlay that makes the later cell tiny, with a control whose
#: budget the ring's few codes still overflow
EXTRA_TINY = {"why": "a ring of 50 nodes, 4,000 edges at one every 90 s, "
                     "in 8 zones of 128 slots",
              "overlay": {"generator": {"n_edges": 4000, "n_nodes": 50,
                                        "gap": 90},
                          "shape": {"n_zones": 8, "e_cap": 128},
                          "mining": {"out_cap": 1024},
                          "control": {"mining": {"out_cap": 4}}},
              "control_breaks": ["codes_wrong", "overflow"]}


def write_extra(root: Path) -> dict:
    """A later cell ``ring.paced`` dropped in under ``root`` as new files
    only, with a new generator, traffic driver and entry, its
    configuration at full size and what the tests need of it (a tiny
    overlay, the entry's faults); returns the ``BENCHMARK.json`` that
    lists it beside the committed cells."""
    for sub, name, text in (("data", "ring_stream.py", EXTRA_GENERATOR),
                            ("drivers", "paced_loop.py", EXTRA_DRIVER),
                            ("entries", "ring_step.py", EXTRA_ENTRY),
                            ("metrics", "calls_per_s.py", EXTRA_METRIC),
                            ("entry_faults", "ring_step.py", EXTRA_FAULTS),
                            ("tiny", "ring.json", json.dumps(EXTRA_TINY))):
        (root / sub).mkdir(parents=True, exist_ok=True)
        (root / sub / name).write_text(text)
    # the committed cell's full shape and a stream as long: the CPU cannot
    # run it inside ``run_cpu``'s timeout
    config = json.loads((ROOT / "configs" / "ptmt-mining.json").read_text())
    config["name"] = "ring"
    config["entry"] = "ring_step"
    config["generator"] = {"name": "ring_stream", "n_edges": 1250000,
                           "n_nodes": 986, "gap": 4}
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
