"""Every piece ``BENCHMARK.json`` names resolves to its file by name, a
piece dropped into another directory is found without editing a file,
and ``BENCHMARK.json`` keeps to the benchmark's contract."""

from __future__ import annotations

import json
import re

import pytest

from ptmt_bench.registry import CHECKOUT, ROOT, Registry

from .kit import tiny, write_extra

BENCH = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"]])
def test_cell_resolves(cell):
    reg = Registry()
    c = reg.cell(cell)
    config = reg.config(c["config"])
    assert config["name"] == c["config"]
    traffic = reg.traffic(c["traffic"])
    assert traffic["name"] == c["traffic"]
    driver = reg.driver(traffic["driver"])
    assert callable(driver.warm) and callable(driver.run_window)
    assert hasattr(reg.entry(config["entry"]), "Session")
    assert callable(reg.data(config["generator"]["name"]).generate)
    assert callable(reg.data(config["batch"]["name"]).build)
    # the checks come from the configuration's limits; its tiny overlay
    # names those its control breaks
    assert config["limits"] and all(
        isinstance(v, (int, float)) for v in config["limits"].values())
    breaks = tiny(c["config"])["control_breaks"]
    assert breaks and set(breaks) <= set(config["limits"])


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"]
                                    + BENCH["per_layer"]])
def test_metric_reader_resolves(metric):
    assert callable(Registry().reader(metric))


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(config):
    path = CHECKOUT / config["file"]
    assert path.is_file() and path.is_relative_to(ROOT)
    data = json.loads(path.read_text())
    assert data["name"] == config["name"]
    assert data["reduced"] == config["reduced"]
    assert len(data["source"]) <= 200 and config["source"] in data["source"]


def test_contract_shape():
    bench, reg = BENCH, Registry()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["ptmt_bench"]
    assert 1 <= bench["run_seconds"] <= 51
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    cells = {c["name"] for c in bench["workloads"]}
    assert {c["config"] for c in bench["workloads"]} == {
        c["name"] for c in bench["configs"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", cells)
    for cell in cells:
        reported = reg.metrics_for(cell, trace=False)
        assert "setup_s" in {m["name"] for m in reported}
        assert len(reported) >= 2
        assert reg.metrics_for(cell, trace=True)


def test_extra_pieces_found_without_edits(tmp_path):
    """A later cell: a configuration, a traffic mix, a traffic driver, a
    generator and a metric reader in files of their own, and entries in a
    BENCHMARK.json; ``test_ptmt_bench_run`` runs it."""
    bench = write_extra(tmp_path)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    reg = Registry(roots=[tmp_path, ROOT],
                   benchmark=tmp_path / "BENCHMARK.json")
    cell = reg.cell("ring.paced")
    config = reg.config(cell["config"])
    traffic = reg.traffic(cell["traffic"])
    assert traffic["calls_per_s"] == 20
    assert config["entry"] == "ring_step"
    assert hasattr(reg.entry(config["entry"]), "Session")
    assert reg.driver(traffic["driver"]).__file__ == str(
        tmp_path / "drivers" / "paced_loop.py")
    u, v, t, n = reg.data(config["generator"]["name"]).generate(
        seed=3, n_edges=10, n_nodes=5, gap=2)
    assert n == 5 and t.tolist() == list(range(0, 20, 2))
    assert (u[1:] == v[:-1]).all()
    assert [m["name"] for m in reg.metrics_for("ring.paced", trace=True)] \
        == ["calls_per_s"]

    class R:
        calls, window_s = 6, 2.0

    assert reg.reader("calls_per_s")(R()) == 3.0
    # the benchmark's own pieces are still found behind the new root
    assert reg.config("ptmt-mining")["entry"] == "mine_step"
    assert reg.driver("closed_loop").__file__ == str(
        ROOT / "drivers" / "closed_loop.py")


def test_unknown_names_raise():
    reg = Registry()
    with pytest.raises(KeyError):
        reg.cell("no-such.cell")
    with pytest.raises(FileNotFoundError):
        reg.config("no-such-config")
    with pytest.raises(FileNotFoundError):
        reg.reader("no_such_metric")
    with pytest.raises(FileNotFoundError):
        reg.driver("no_such_driver")
    with pytest.raises(FileNotFoundError):
        reg.data("no_such_generator")
