"""``run.py`` end to end on the CPU at tiny sizes, past its look for a
card: the last line's schema, ``correct`` true on the program as it is,
false with the control switched on and with each fault the cell can have
planted under the timed path.  Each committed cell is run so, and a later
cell dropped in as new files only (``kit.write_extra``); what each test
expects of a cell comes from its configuration's files and its entry's
fault module."""

from __future__ import annotations

import json
from concurrent.futures import ThreadPoolExecutor

import pytest

from ptmt_bench.registry import CHECKOUT, ROOT, Registry

from . import faults
from .kit import TESTS, run_cpu, tiny, write_extra, write_tiny

#: the cells of BENCHMARK.json
CELLS = [c["name"] for c in json.loads(
    (CHECKOUT / "BENCHMARK.json").read_text())["workloads"]]
#: the later cell of ``kit.write_extra``, run through the same tests
DROPPED_IN = "ring.paced"


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """The root each cell's tiny configuration is found under: the
    committed cells' own, and the dropped-in cell's."""
    committed = write_tiny(tmp_path_factory.mktemp("tiny"))
    extra = tmp_path_factory.mktemp("extra")
    write_tiny(extra, write_extra(extra))
    return {**dict.fromkeys(CELLS, committed), DROPPED_IN: extra}


@pytest.fixture(scope="module")
def runs(roots):
    """Every run the tests below read, four at a time: each is a process
    that spends most of its time importing torch.  Keyed by cell and
    ``"sound"``, ``"control"`` or a fault; each holds ``run_cpu``'s
    result."""
    variants = {"sound": {}, "control": {"control": True},
                **{f: {"fault": f} for f in faults.FAULTS}}
    with ThreadPoolExecutor(max_workers=4) as pool:
        futures = {(cell, v): pool.submit(run_cpu, root, cell, **kw)
                   for cell, root in roots.items()
                   for v, kw in variants.items()}
        yield futures
        for f in futures.values():
            f.exception()


def registry(root) -> Registry:
    """The registry a run under ``root`` finds its pieces with."""
    return Registry(roots=[root, ROOT], benchmark=root / "BENCHMARK.json")


def config_of(root, cell) -> dict:
    """The cell's configuration as the run under ``root`` reads it."""
    reg = registry(root)
    return reg.config(reg.cell(cell)["config"])


@pytest.mark.parametrize("cell", CELLS + [DROPPED_IN])
def test_last_line(roots, runs, cell):
    rc, last, err = runs[cell, "sound"].result()
    assert rc == 0, err[-3000:]
    assert list(last)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(last)[-1] == "checks"
    assert last["correct"] is True and last["failed"] == 0
    assert last["attempted"] >= 1
    assert set(last["metrics"]) == {
        m["name"] for m in registry(roots[cell]).metrics_for(
            cell, trace=False)}
    for m in last["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(last["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    # one check per limit of the configuration, in its order, each
    # within its limit
    limits = config_of(roots[cell], cell)["limits"]
    assert list(last["checks"]) == list(limits)
    for name, c in last["checks"].items():
        assert set(c) == {"value", "limit"} and c["limit"] == limits[name]
        assert 0 <= c["value"] <= c["limit"]
    # the numbers compared, beside their limits, are stderr's last lines
    tail = err.strip().splitlines()[-len(limits):]
    assert tail == [f"check {n}: {c['value']} (limit {c['limit']})"
                    for n, c in last["checks"].items()]


@pytest.mark.parametrize("cell", CELLS + [DROPPED_IN])
def test_control_is_not_correct(roots, runs, cell):
    breaks = tiny(config_of(roots[cell], cell)["name"],
                  roots[cell])["control_breaks"]
    rc, last, err = runs[cell, "control"].result()
    assert rc == 0, err[-3000:]
    assert last["correct"] is False
    for name in breaks:
        c = last["checks"][name]
        assert c["value"] > c["limit"], name


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("cell", CELLS + [DROPPED_IN])
def test_fault_is_not_correct(roots, runs, cell, fault):
    module = faults.entry_module(config_of(roots[cell], cell)["entry"],
                                 roots[cell])
    rc, last, err = runs[cell, fault].result()
    assert rc == 0, err[-3000:]
    assert last["correct"] is False
    for name in module.BREAKS[fault]:
        c = last["checks"][name]
        assert c["value"] > c["limit"], name


def test_a_dropped_in_cell_runs(runs, tmp_path):
    """The later cell of ``kit.write_extra`` (new generator, driver,
    entry, configuration, traffic and metric files, with its tiny overlay
    and its entry's faults) runs end to end and is correct; its
    configuration is written at full size, and none of its files is one
    the checkout has: the drop-in edited nothing."""
    rc, last, err = runs[DROPPED_IN, "sound"].result()
    assert rc == 0, err[-3000:]
    assert last["correct"] is True and last["attempted"] >= 2
    write_extra(tmp_path)
    written = [p.relative_to(tmp_path) for p in tmp_path.rglob("*")
               if p.is_file()]
    assert {"configs/ring.json", "tiny/ring.json", "entries/ring_step.py",
            "entry_faults/ring_step.py"} <= {str(p) for p in written}
    for rel in written:
        assert not (ROOT / rel).exists() and not (TESTS / rel).exists(), rel
    full = json.loads((tmp_path / "configs" / "ring.json").read_text())
    assert full["shape"] == Registry().config("ptmt-mining")["shape"]


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_on_the_card(roots, cell):
    """``--trace 1`` reads the profiler's CUDA trace, so it runs on the
    card only: every per-layer metric of the cell is reported."""
    import subprocess
    import sys

    import torch

    if not torch.cuda.is_available():
        pytest.skip("the traced run reads a CUDA trace: it needs the card")
    tiny = roots[cell]
    bench = tiny / "BENCHMARK.json"
    code = (f"import sys; sys.path[:0] = [{str(CHECKOUT)!r}]\n"
            "from ptmt_bench.registry import Registry, ROOT\n"
            "from ptmt_bench import run\n"
            f"reg = Registry(roots=[{str(tiny)!r}, ROOT], "
            f"benchmark={str(bench)!r})\n"
            f"sys.exit(run.main(['--workload', {cell!r}, '--seed', '5', "
            "'--seconds', '1', '--trace', '1'], registry=reg))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(CHECKOUT))
    assert out.returncode == 0, out.stderr[-3000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    want = {m["name"] for m in Registry(benchmark=bench).metrics_for(
        cell, trace=True)}
    assert last["correct"] is True and set(last["metrics"]) == want
    assert 0 < last["device"]["busy_s"] <= last["device"]["window_s"]
