"""Finds each piece of the benchmark by its name, so that a later cell
needs new files and entries only:

* ``BENCHMARK.json`` at the root of the checkout: the cells and metrics;
* ``configs/<name>.json``: a configuration (its source, the program's
  entry it drives and how, the generator of its data, the reference it is
  held to and the limits of each number compared);
* ``traffic/<name>.json``: a traffic mix, the parameters of the driver it
  names;
* ``drivers/<name>.py``: a traffic driver, ``warm(session, traffic)`` and
  ``run_window(session, traffic, seconds=, seed=)``;
* ``data/<name>.py``: a generator (``generate``) or batch builder
  (``build``) of the inputs, as a configuration names it;
* ``metrics/<name>.py``: the reader of one metric, ``read(record)``;
* ``entries/<name>.py``: the adapter that builds the program's entry from
  a configuration and calls it (``Session``).

A registry searches a list of roots in order, so a test can put extra
pieces in front of the benchmark's own.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CHECKOUT = ROOT.parent


class Registry:
    def __init__(self, roots=(ROOT,), benchmark: Path | None = None):
        self.roots = [Path(r) for r in roots]
        self.benchmark_path = Path(benchmark or CHECKOUT / "BENCHMARK.json")
        self._modules: dict[Path, object] = {}

    def benchmark(self) -> dict:
        return json.loads(self.benchmark_path.read_text())

    def find(self, kind: str, name: str, suffix: str) -> Path:
        for root in self.roots:
            path = root / kind / f"{name}{suffix}"
            if path.is_file():
                return path
        raise FileNotFoundError(
            f"no {kind}/{name}{suffix} under "
            f"{', '.join(map(str, self.roots))}")

    def cell(self, name: str) -> dict:
        for cell in self.benchmark()["workloads"]:
            if cell["name"] == name:
                return cell
        raise KeyError(f"no workload named {name!r} in "
                       f"{self.benchmark_path}")

    def config(self, name: str) -> dict:
        return json.loads(self.find("configs", name, ".json").read_text())

    def traffic(self, name: str) -> dict:
        return json.loads(self.find("traffic", name, ".json").read_text())

    def module(self, kind: str, name: str):
        path = self.find(kind, name, ".py")
        mod = self._modules.get(path)
        if mod is None:
            tag = re.sub(r"\W", "_", f"ptmt_bench_{kind}_{name}")
            spec = importlib.util.spec_from_file_location(tag, path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._modules[path] = mod
        return mod

    def reader(self, metric: str):
        return self.module("metrics", metric).read

    def entry(self, name: str):
        return self.module("entries", name)

    def driver(self, name: str):
        return self.module("drivers", name)

    def data(self, name: str):
        return self.module("data", name)

    def session(self, config: dict, *, seed, device, traced: bool):
        """The configuration's entry, set up to be driven: its
        ``Session`` with this registry to find its inputs' makers."""
        return self.entry(config["entry"]).Session(
            config, seed=seed, device=device, traced=traced, registry=self)

    def metrics_for(self, cell: str, *, trace: bool) -> list[dict]:
        """The cell's end-to-end metrics (``trace`` False) or per-layer
        metrics (``trace`` True), as ``BENCHMARK.json`` lists them."""
        bench = self.benchmark()
        if not trace:
            return [m for m in bench["end_to_end"]
                    if cell in m.get("workloads", [cell])]
        reported = {m["name"] for m in self.metrics_for(cell, trace=False)}
        return [m for m in bench["per_layer"]
                if cell in m.get("workloads", [cell] if m["moves"]
                                 in reported else [])]
