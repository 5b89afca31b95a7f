"""The port's batch discovery end to end against the JAX package's:
``PTMTEngine(device="cpu")`` with ``backend="cuda"`` runs the fused
kernel's plain version on the CPU and must give the counts the JAX
package's ``discover`` gives with ``backend="pallas"`` (exact)."""

import os
import subprocess
import sys
import warnings

import pytest
import torch

from repro.core import MiningConfig as JaxConfig
from repro.core import PTMTEngine as JaxEngine
from repro.data import synthetic_graphs as j_graphs
from repro_torch.core import MiningConfig, MiningExecutor, PTMTEngine
from repro_torch.core import executor as t_executor
from repro_torch.core import transitions, tzp
from repro_torch.data import synthetic_graphs
from torch_corpus import powerlaw_bursty

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_STATS = ("bounds", "launches", "spill_retries", "merge_cap", "fold_chunk",
          "n_slots", "sweep_slots")


def _discover_both(graph, **cfg):
    j = JaxEngine(JaxConfig(backend="pallas", **cfg)).discover(graph)
    t = PTMTEngine(MiningConfig(backend="cuda", **cfg),
                   device="cpu").discover(graph)
    return j, t


@pytest.mark.parametrize("name,make,cfg", [
    ("bursty", lambda: powerlaw_bursty(5), dict(delta=12, l_max=3, omega=2)),
    ("bursty-l7", lambda: powerlaw_bursty(5),
     dict(delta=30, l_max=7, omega=2)),
    ("collegemsg-like", lambda: j_graphs.make("collegemsg-like"),
     dict(delta=900, l_max=3, omega=6)),
])
def test_discover_counts_equal_jax(name, make, cfg):
    j, t = _discover_both(make(), **cfg)
    assert t.counts == j.counts
    assert (t.n_zones, t.e_cap, t.overflow) == (j.n_zones, j.e_cap,
                                                j.overflow)
    je, te = j.layout["execution"], t.layout["execution"]
    assert te["path"] == "fused_torch" and je["path"] == "fused_xla"
    assert {k: te[k] for k in _STATS} == {k: je[k] for k in _STATS}


def test_sequential_ref_counts_equal():
    g = powerlaw_bursty(5)
    cfg = dict(delta=12, l_max=3, omega=2)
    t_seq = PTMTEngine(MiningConfig(backend="ref", **cfg),
                       device="cpu").sequential(g)
    j_seq = JaxEngine(JaxConfig(backend="ref", zone_chunk=0,
                                **cfg)).sequential(g)
    assert t_seq.counts == j_seq.counts
    t_disc = PTMTEngine(MiningConfig(backend="cuda", **cfg),
                        device="cpu").discover(g)
    assert t_disc.counts == t_seq.counts


def test_spill_retry_stats_match():
    """An explicit tiny merge_cap spills and retries identically."""
    g = powerlaw_bursty(5)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        j, t = _discover_both(g, delta=30, l_max=7, omega=2, merge_cap=8)
    assert t.counts == j.counts
    te, je = t.layout["execution"], j.layout["execution"]
    assert te["spill_retries"] > 0
    assert {k: te[k] for k in _STATS} == {k: je[k] for k in _STATS}


def test_spill_adapted_cap_persists_like_jax():
    """Without a pinned cap the first run spills, and the next run on the
    same engine starts at the adapted cap (no retry) — in both packages."""
    g = synthetic_graphs.powerlaw_stream(12000, 300, seed=1)
    cfg = dict(delta=600, l_max=6, omega=20)
    j_engine = JaxEngine(JaxConfig(backend="pallas", **cfg))
    t_engine = PTMTEngine(MiningConfig(backend="cuda", **cfg), device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        runs = [(e.discover(g), e.discover(g)) for e in (j_engine, t_engine)]
    (j1, j2), (t1, t2) = runs
    assert t1.counts == j1.counts == t2.counts == j2.counts
    for a, b in ((t1, j1), (t2, j2)):
        ae, be = a.layout["execution"], b.layout["execution"]
        assert {k: ae[k] for k in _STATS} == {k: be[k] for k in _STATS}
    assert t1.layout["execution"]["spill_retries"] == 1
    assert t2.layout["execution"]["spill_retries"] == 0


def test_memory_budget_plans_the_fold():
    g = powerlaw_bursty(5)
    cfg = dict(delta=12, l_max=3, omega=2)
    t = PTMTEngine(MiningConfig(backend="cuda", memory_budget_mb=0.05,
                                **cfg), device="cpu").discover(g)
    j = JaxEngine(JaxConfig(backend="pallas", **cfg)).discover(g)
    assert t.counts == j.counts
    assert t.layout["execution"]["fold_chunk"] == 512


def test_ref_backend_with_torch_fused_scan():
    g = powerlaw_bursty(5)
    cfg = dict(delta=12, l_max=3, omega=2)
    t = PTMTEngine(MiningConfig(backend="ref", fused_backend="torch", **cfg),
                   device="cpu").discover(g)
    j = JaxEngine(JaxConfig(backend="pallas", **cfg)).discover(g)
    assert t.counts == j.counts
    assert t.layout["execution"]["path"] == "fused_torch"


def test_engine_without_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PTMTEngine(MiningConfig(backend="cuda"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MiningExecutor(delta=5, l_max=3)
    assert PTMTEngine(device="cpu").device == torch.device("cpu")


def test_paths_of_later_slices_raise():
    g = powerlaw_bursty(5)
    with pytest.raises(NotImplementedError, match="slice 2"):
        PTMTEngine(MiningConfig(delta=12, l_max=3, omega=2),
                   device="cpu").discover(g)          # ref: per-bucket
    with pytest.raises(NotImplementedError, match="slice 2"):
        PTMTEngine(MiningConfig(backend="cuda", delta=12, l_max=3,
                                omega=2), device="cpu").sequential(g)
    with pytest.raises(NotImplementedError, match="slice 2"):
        PTMTEngine(MiningConfig(backend="cuda", fused="off", delta=12,
                                l_max=3, omega=2), device="cpu").discover(g)
    with pytest.raises(NotImplementedError, match="slice 2"):
        PTMTEngine(MiningConfig(delta=12, l_max=3, omega=2,
                                memory_budget_mb=1.0),
                   device="cpu").sequential(g)         # budget-derived chunk
    ex = MiningExecutor(delta=12, l_max=3, agg="hierarchical", device="cpu")
    batch = tzp.build_zone_batch(g, tzp.single_zone_plan(g, l_b=36))
    with pytest.raises(NotImplementedError, match="slice 2"):
        ex.run(batch)


def test_zone_chunked_legacy_batch_equals_unchunked():
    g = powerlaw_bursty(5)
    plan = tzp.plan_zones(g, delta=12, l_max=3, omega=2)
    batch = tzp.build_zone_batch(g, plan)
    whole = MiningExecutor(delta=12, l_max=3, device="cpu").run(batch)
    chunked = MiningExecutor(delta=12, l_max=3, zone_chunk=3, agg="legacy",
                             device="cpu").run(batch)
    # padding to a zone_chunk multiple adds inert rows: same counts,
    # longer table
    as_dict = transitions.device_counts_to_dict
    assert as_dict(chunked) == as_dict(whole)
    assert chunked.codes.shape[0] > whole.codes.shape[0]
    with pytest.raises(t_executor.ZoneChunkError):
        MiningExecutor(delta=12, l_max=3, zone_chunk=3, agg="legacy",
                       pad_policy="raise", device="cpu").run(batch)


def _mine(*args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.mine", *args],
        capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)


def test_mine_cli_check_sequential_on_cpu():
    out = _mine("--device", "cpu", "--backend", "cuda", "--dataset",
                "collegemsg-like", "--delta", "900", "--l-max", "3",
                "--omega", "6", "--check-sequential")
    assert out.returncode == 0, out.stderr
    assert "sequential baseline on backend 'ref'" in out.stdout
    assert "exact match: True" in out.stdout


def test_mine_cli_stream_not_ported():
    out = _mine("--device", "cpu", "--stream")
    assert out.returncode != 0
    assert "slice 4" in out.stderr
