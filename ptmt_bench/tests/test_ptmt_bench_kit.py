"""What the CPU tests need of a configuration or an entry comes in files of
its own, found by name in a drop-in root first: each configuration's tiny
overlay (``tiny/<config>.json``) and each entry's faults
(``entry_faults/<entry>.py``).  A missing one fails naming the file to
add, and no configuration is ever run at its full size."""

from __future__ import annotations

import json

import pytest

from ptmt_bench.registry import CHECKOUT, Registry

from . import faults
from .kit import check_keys, tiny, write_extra, write_tiny

BENCH = json.loads((CHECKOUT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_every_configuration_has_a_tiny_overlay(config):
    full = Registry().config(config)
    found = tiny(config)
    check_keys(found["overlay"], full)
    breaks = found["control_breaks"]
    assert breaks and set(breaks) <= set(full["limits"])


@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"]])
def test_every_entry_has_a_fault_module(cell):
    reg = Registry()
    config = reg.config(reg.cell(cell)["config"])
    module = faults.entry_module(config["entry"])
    assert set(faults.FAULTS) <= set(module.BREAKS)
    assert callable(module.plant)
    for checks in module.BREAKS.values():
        assert checks and set(checks) <= set(config["limits"])


def test_a_drop_in_root_is_searched_first(tmp_path):
    committed = tiny("ptmt-mining")
    mine = json.loads(json.dumps(committed))
    mine["overlay"]["shape"]["n_zones"] = 4
    (tmp_path / "tiny").mkdir()
    (tmp_path / "tiny" / "ptmt-mining.json").write_text(json.dumps(mine))
    assert tiny("ptmt-mining", tmp_path) == mine
    assert tiny("ptmt-mining") == committed
    write_tiny(tmp_path)
    written = json.loads(
        (tmp_path / "configs" / "ptmt-mining.json").read_text())
    assert written["shape"]["n_zones"] == 4

    (tmp_path / "entry_faults").mkdir()
    (tmp_path / "entry_faults" / "mine_step.py").write_text(
        "BREAKS = {'answer': ['overflow']}\n")
    assert faults.entry_module("mine_step", tmp_path).BREAKS == {
        "answer": ["overflow"]}
    assert faults.entry_module("mine_step").BREAKS["answer"] == [
        "codes_wrong"]


def test_a_configuration_without_an_overlay_raises(tmp_path):
    """The drop-in's configuration, at full size, without its overlay:
    nothing is written, and the error names the file to add."""
    bench = write_extra(tmp_path)
    (tmp_path / "tiny" / "ring.json").unlink()
    full = (tmp_path / "configs" / "ring.json").read_text()
    with pytest.raises(FileNotFoundError, match=r"tests/tiny/ring\.json"):
        write_tiny(tmp_path, bench)
    assert (tmp_path / "configs" / "ring.json").read_text() == full
    assert not (tmp_path / "configs" / "ptmt-mining.json").exists()
    assert not (tmp_path / "BENCHMARK.json").exists()


@pytest.mark.parametrize("overlay, key", [
    ({"shapes": {"n_zones": 8}}, "'shapes'"),
    ({"shape": {"n_zone": 8}}, "'shape.n_zone'"),
    ({"control": {"mining": {"out_caps": 64}}}, "'control.mining.out_caps'"),
], ids=["top", "nested", "deeper"])
def test_an_overlay_key_not_in_its_configuration_raises(tmp_path, overlay,
                                                         key):
    (tmp_path / "tiny").mkdir()
    (tmp_path / "tiny" / "ptmt-mining.json").write_text(json.dumps(
        {"overlay": overlay, "control_breaks": ["overflow"]}))
    with pytest.raises(ValueError, match=key):
        write_tiny(tmp_path)


def test_an_entry_without_a_fault_module_raises(tmp_path):
    with pytest.raises(FileNotFoundError,
                       match=r"tests/entry_faults/no_such_entry\.py"):
        faults.entry_module("no_such_entry", tmp_path)
