"""The port's batch discovery end to end against the JAX package's:
``PTMTEngine(device="cpu")`` with ``backend="cuda"`` runs the fused
kernel's plain version on the CPU and must give the counts the JAX
package's ``discover`` gives with ``backend="pallas"`` (exact)."""

import functools
import os
import subprocess
import sys
import warnings

import pytest
import torch

from repro.core import MiningConfig as JaxConfig
from repro.core import MiningExecutor as JaxExecutor
from repro.core import PTMTEngine as JaxEngine
from repro.core import transitions as j_transitions
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


def _slice2_call(which, g):
    """The five calls that raised before the per-bucket path was ported,
    each run in both packages: ``(port result, JAX result)``."""
    cfg = dict(delta=12, l_max=3, omega=2)
    if which == "default-ref-discover":        # ref: the per-bucket path
        return (PTMTEngine(MiningConfig(**cfg), device="cpu").discover(g),
                JaxEngine(JaxConfig(**cfg)).discover(g))
    if which == "cuda-sequential":
        return (PTMTEngine(MiningConfig(backend="cuda", **cfg),
                           device="cpu").sequential(g),
                JaxEngine(JaxConfig(backend="pallas", **cfg)).sequential(g))
    if which == "cuda-fused-off-discover":
        return (PTMTEngine(MiningConfig(backend="cuda", fused="off", **cfg),
                           device="cpu").discover(g),
                JaxEngine(JaxConfig(backend="pallas", fused="off",
                                    **cfg)).discover(g))
    if which == "budget-sequential":           # budget-derived zone chunk
        return (PTMTEngine(MiningConfig(memory_budget_mb=1.0, **cfg),
                           device="cpu").sequential(g),
                JaxEngine(JaxConfig(memory_budget_mb=1.0,
                                    **cfg)).sequential(g))
    batch = tzp.build_zone_batch(g, tzp.single_zone_plan(g, l_b=36))
    t = MiningExecutor(delta=12, l_max=3, agg="hierarchical",
                       device="cpu").run(batch)
    j = JaxExecutor(delta=12, l_max=3, agg="hierarchical").run(batch)
    return t, j


@pytest.mark.parametrize("which", [
    "default-ref-discover", "cuda-sequential", "cuda-fused-off-discover",
    "budget-sequential", "hierarchical-executor-run"])
def test_slice2_paths_equal_jax(which):
    """The per-bucket path, the sequential baseline on cuda, budget-derived
    chunks and the bounded fold, against the JAX package."""
    t, j = _slice2_call(which, powerlaw_bursty(5))
    if which == "hierarchical-executor-run":
        assert transitions.device_counts_to_dict(t) == \
            j_transitions.device_counts_to_dict(j)
        return
    assert t.counts == j.counts
    assert (t.n_zones, t.e_cap, t.overflow) == (j.n_zones, j.e_cap,
                                                j.overflow)
    if "execution" in j.layout:
        assert t.layout["execution"] == j.layout["execution"]


_CLI = ["--device", "cpu", "--backend", "cuda", "--dataset",
        "collegemsg-like", "--delta", "60", "--l-max", "3", "--omega", "6"]


def test_stream_still_raises_naming_its_slice(tmp_path):
    """Streaming (slice 4) is ported, so ``--stream`` no longer raises: it
    replays the dataset through ``engine.stream()`` and ends at the batch
    run's counts.  Both modes write one summary schema, the JAX package's
    keys plus ``device`` (``stream`` null in batch mode), and
    ``--tree-depth`` is accepted as in the JAX CLI."""
    import argparse
    import json

    from repro.launch import mine as j_mine
    from repro_torch.launch import mine

    out = {m: str(tmp_path / f"{m}.json") for m in ("batch", "stream")}
    mine.main(_CLI + ["--tree-depth", "3", "--out-json", out["batch"]])
    mine.main(_CLI + ["--stream", "--chunk-edges", "5000", "--out-json",
                      out["stream"]])
    batch, stream = (json.load(open(out[m])) for m in ("batch", "stream"))

    graph = j_graphs.make("collegemsg-like")
    res = JaxEngine(JaxConfig(delta=60, l_max=3, omega=6)).discover(graph)
    jax_keys = set(j_mine._summary(
        argparse.Namespace(dataset="collegemsg-like", seed=0),
        JaxConfig(delta=60, l_max=3, omega=6), graph, res, 1.0, "batch",
        None))
    for summary, mode in ((batch, "batch"), (stream, "stream")):
        assert set(summary) == jax_keys | {"device"}, mode
        assert summary["mode"] == mode and summary["device"] == "cpu"
    assert batch["stream"] is None
    assert stream["stream"]["chunk_edges"] == 5000
    assert stream["stream"]["chunks"] == 4
    assert set(stream["stream"]) == {
        "chunk_edges", "chunks", "mean_chunk_ms", "max_chunk_ms",
        "p50_chunk_ms", "p99_chunk_ms", "zones_finalized", "edges_retired",
        "buffered_edges", "epoch"}
    assert stream["counts"] == batch["counts"] == res.counts


#: per-bucket runs of every port backend in every agg mode, each held
#: against the JAX package's ``ref`` backend in the same mode
_AGG = {
    "legacy": dict(agg="legacy"),
    "hierarchical": dict(agg="hierarchical", zone_chunk=2),
    "pipelined": dict(agg="pipelined", zone_chunk=2),
    "budget": dict(memory_budget_mb=0.05),
}


@functools.lru_cache(maxsize=None)
def _jax_per_bucket(mode):
    cfg = JaxConfig(delta=30, l_max=4, omega=2, fused="off", **_AGG[mode])
    return JaxEngine(cfg).discover(powerlaw_bursty(5))


@pytest.mark.parametrize("mode", list(_AGG))
@pytest.mark.parametrize("backend", ["ref", "torch", "numpy", "cuda"])
def test_per_bucket_discover_equals_jax(backend, mode):
    g = powerlaw_bursty(5)
    eng = PTMTEngine(MiningConfig(delta=30, l_max=4, omega=2, fused="off",
                                  backend=backend, **_AGG[mode]),
                     device="cpu")
    t = eng.discover(g)
    j = _jax_per_bucket(mode)
    assert t.counts == j.counts
    assert t.layout == j.layout
    assert t.layout["execution"]["path"] == "per-bucket"
    assert eng.stats.launches == len(t.layout["buckets"])


def test_tiny_merge_cap_spills_and_retries_like_jax():
    """Per-bucket hierarchical folds at merge_cap=8: the same spill
    warnings, in the same number, and the same exact counts."""
    g = powerlaw_bursty(5)
    cfg = dict(delta=30, l_max=7, omega=2, zone_chunk=2, merge_cap=8,
               fused="off")
    with warnings.catch_warnings(record=True) as t_warn:
        warnings.simplefilter("always")
        t = PTMTEngine(MiningConfig(**cfg), device="cpu").discover(g)
    with warnings.catch_warnings(record=True) as j_warn:
        warnings.simplefilter("always")
        j = JaxEngine(JaxConfig(**cfg)).discover(g)
    spills = lambda ws: [str(w.message) for w in ws
                         if "spilled" in str(w.message)]
    assert spills(t_warn) == spills(j_warn) != []
    assert t.counts == j.counts


def test_execution_keys_match_jax():
    g = powerlaw_bursty(5)
    cfg = dict(delta=30, l_max=4, omega=2, memory_budget_mb=0.05)
    t = PTMTEngine(MiningConfig(**cfg), device="cpu")
    j = JaxEngine(JaxConfig(**cfg))
    layout = tzp.build_zone_layout(g, tzp.plan_zones(g, delta=30, l_max=4,
                                                     omega=2))
    t_keys = t.executor.layout_execution_keys(layout)
    j_keys = j.executor.layout_execution_keys(layout)
    assert t_keys == j_keys and len(t_keys) == layout.n_buckets
    for b in layout.buckets:
        assert t.capacity_plan(b.n_zones, b.e_cap).__dict__ == \
            j.capacity_plan(b.n_zones, b.e_cap).__dict__


def test_scan_aggregate_partial_reports_spills():
    """The one-pass cores: exact at a wide cap, a positive spill count at
    a tiny one (the caller re-runs), legacy with no spill."""
    g = powerlaw_bursty(5)
    batch = tzp.build_zone_batch(g, tzp.plan_zones(g, delta=30, l_max=4,
                                                   omega=2))
    assert batch.n_zones % 3 == 0
    arrays = [torch.as_tensor(x) for x in (batch.u, batch.v, batch.t,
                                           batch.valid, batch.sign)]
    as_dict = transitions.device_counts_to_dict
    whole = MiningExecutor(delta=30, l_max=4, device="cpu").scan_aggregate(
        *arrays)
    for cap, spills in ((None, False), (8, True)):
        ex = MiningExecutor(delta=30, l_max=4, zone_chunk=3, merge_cap=cap,
                            agg="hierarchical", device="cpu")
        counts, spilled = ex.scan_aggregate_partial(*arrays)
        assert bool(spilled) == spills
        if not spills:
            assert as_dict(counts) == as_dict(whole)
    with pytest.raises(ValueError, match="host-only"):
        MiningExecutor(delta=30, l_max=4, backend="numpy",
                       device="cpu").scan_aggregate(*arrays)


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
    assert "sequential TMC-analog (backend 'cuda')" in out.stdout
    assert "exact match: True" in out.stdout


def test_mine_cli_stream_not_ported():
    """``--stream`` runs as a command (slice 4 is ported): the frontier
    report, then the final snapshot."""
    out = _mine(*_CLI, "--stream", "--chunk-edges", "8000")
    assert out.returncode == 0, out.stderr
    assert "stream: 3 chunks of 8000 edges" in out.stdout
    assert "frontier:" in out.stdout and "PTMT-stream:" in out.stdout


@pytest.mark.parametrize("module", ["repro_torch.launch.mine",
                                    "repro_torch.launch.serve_motifs"])
def test_clis_raise_without_cuda_by_default(module):
    """Both CLIs run on CUDA unless ``--device`` says otherwise, and fail
    on a host without it rather than carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", module, "--dataset", "collegemsg-like"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
