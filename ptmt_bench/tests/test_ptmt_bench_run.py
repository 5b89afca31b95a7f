"""``run.py`` end to end on the CPU at tiny sizes, past its look for a
card: the last line's schema, ``correct`` true on the program as it is,
false with the control switched on and with each fault the cell can have
planted under the timed path."""

from __future__ import annotations

import json

import pytest

from ptmt_bench.registry import CHECKOUT

from .kit import run_cpu, write_extra, write_tiny

#: the cells of BENCHMARK.json
CELLS = [c["name"] for c in json.loads(
    (CHECKOUT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return write_tiny(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("cell", CELLS)
def test_last_line(tiny, cell):
    rc, last, err = run_cpu(tiny, cell)
    assert rc == 0, err[-3000:]
    assert list(last)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(last)[-1] == "checks"
    assert last["correct"] is True and last["failed"] == 0
    assert last["attempted"] >= 1
    assert set(last["metrics"]) == {"setup_s", "mine_edges_per_s"}
    for m in last["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(last["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert last["checks"] == {"codes_wrong": {"value": 0, "limit": 0},
                              "overflow": {"value": 0, "limit": 0}}
    # the numbers compared, beside their limits, are stderr's last lines
    tail = err.strip().splitlines()[-2:]
    assert tail == ["check codes_wrong: 0 (limit 0)",
                    "check overflow: 0 (limit 0)"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tiny, cell):
    rc, last, err = run_cpu(tiny, cell, control=True)
    assert rc == 0, err[-3000:]
    assert last["correct"] is False
    assert last["checks"]["overflow"]["value"] > 0
    assert last["checks"]["codes_wrong"]["value"] > 0


@pytest.mark.parametrize("fault", ["answer", "half", "unchanged"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(tiny, cell, fault):
    rc, last, err = run_cpu(tiny, cell, fault=fault)
    assert rc == 0, err[-3000:]
    assert last["correct"] is False
    assert last["checks"]["codes_wrong"]["value"] > 0


def test_a_dropped_in_cell_runs(tmp_path):
    """The later cell of ``kit.write_extra`` (new generator, driver,
    configuration, traffic and metric files, no file edited) runs end to
    end and is correct."""
    bench = write_extra(tmp_path)
    write_tiny(tmp_path, bench)
    rc, last, err = run_cpu(tmp_path, "ring.paced")
    assert rc == 0, err[-3000:]
    assert last["correct"] is True and last["attempted"] >= 2
    assert set(last["metrics"]) == {"setup_s", "mine_edges_per_s"}


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_on_the_card(tiny, cell):
    """``--trace 1`` reads the profiler's CUDA trace, so it runs on the
    card only: every per-layer metric of the cell is reported."""
    import subprocess
    import sys

    import torch

    if not torch.cuda.is_available():
        pytest.skip("the traced run reads a CUDA trace: it needs the card")
    from ptmt_bench.registry import Registry

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
