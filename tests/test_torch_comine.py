"""Config-lattice co-mining and the per-bucket capacity planner of the port
against the JAX package: ``engine.discover_many`` equals the JAX package's
``discover_many`` and the port's own per-config ``discover``, byte for
byte, on the fused and the per-bucket layouts; lattices and budget-derived
plans equal the JAX package's for the ``ref`` memory model."""

import warnings

import pytest

from repro.core import MiningConfig as JaxConfig
from repro.core import PTMTEngine as JaxEngine
from repro.core import planner as j_planner
from repro_torch.core import MiningConfig, MiningExecutor, PTMTEngine
from repro_torch.core import planner, tzp
from conftest import random_graph
from torch_corpus import powerlaw_bursty

#: port backend -> the JAX backend it is held against
JAX_NAME = {"ref": "ref", "cuda": "pallas", "torch": "xla",
            "numpy": "numpy"}


def _graph(seed=3, n=300, nodes=30, span=1500):
    return random_graph(seed, n, nodes, span)


def _lattice_configs(backend, **extra):
    """A 4-member lattice: dominating member + strict delta/l_max/omega
    sub-configs (one varying each axis)."""
    base = MiningConfig(delta=50, l_max=4, omega=3, backend=backend, **extra)
    return [
        base,
        base.with_updates(delta=20, l_max=3),
        base.with_updates(delta=35, l_max=2, omega=2),
        base.with_updates(delta=50, l_max=4, omega=4),
    ]


def _jax(cfg):
    return JaxConfig(**{**cfg.to_dict(), "backend": JAX_NAME[cfg.backend]})


def _engine(cfg):
    return PTMTEngine(cfg, device="cpu")


# ---------------------------------------------------------------------------
# Planner: budget-derived per-bucket plans and lattices.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("budget", [0.02, 0.25, 4.0])
@pytest.mark.parametrize("shape,l_max,cap", [
    ((9, 4096), 6, None), ((64, 128), 3, None), ((5, 72464), 7, 512),
])
def test_plan_capacity_matches_jax(budget, shape, l_max, cap):
    kw = dict(n_zones=shape[0], e_cap=shape[1], l_max=l_max,
              memory_budget_mb=budget, merge_cap=cap)
    got = planner.plan_capacity(**kw, mem_model=planner.ref_zone_bytes)
    want = j_planner.plan_capacity(**kw, mem_model=j_planner.ref_zone_bytes)
    assert got.__dict__ == want.__dict__
    assert got.fits == want.fits


def test_plan_layout_capacity_and_peaks_match_jax():
    shapes = [(4, 4096), (1, 65536), (4, 72464), (4, 4096)]
    got = planner.plan_layout_capacity(shapes, l_max=6, memory_budget_mb=8)
    want = j_planner.plan_layout_capacity(shapes, l_max=6,
                                          memory_budget_mb=8)
    assert list(got) == list(want) == [(4, 4096), (1, 65536), (4, 72464)]
    assert {k: p.__dict__ for k, p in got.items()} == \
        {k: p.__dict__ for k, p in want.items()}
    assert planner.layout_peak_bytes(got) == j_planner.layout_peak_bytes(want)
    assert planner.legacy_peak_bytes(9, 4096, 6, zone_chunk=2) == \
        j_planner.legacy_peak_bytes(9, 4096, 6, zone_chunk=2)
    assert planner.comine_peak_bytes(2, 4096, 6, merge_caps=(8192, 1024)) == \
        j_planner.comine_peak_bytes(2, 4096, 6, merge_caps=(8192, 1024))


def test_cuda_memory_model_counts_what_the_dense_kernel_allocates():
    """4 int32 inputs and L + 1 int32 outputs per slot, no tile padding:
    more zones per chunk than the reference model allows."""
    assert planner.cuda_zone_bytes(1000, 6) == 1000 * 4 * (4 + 2 + 1)
    cuda = planner.plan_capacity(n_zones=64, e_cap=4096, l_max=6,
                                 memory_budget_mb=16,
                                 mem_model=planner.cuda_zone_bytes)
    ref = planner.plan_capacity(n_zones=64, e_cap=4096, l_max=6,
                                memory_budget_mb=16,
                                mem_model=planner.ref_zone_bytes)
    assert cuda.zone_chunk > ref.zone_chunk


def test_build_config_lattices_matches_jax():
    a = MiningConfig(delta=50, l_max=4, backend="ref")
    cfgs = [a, a.with_updates(backend="numpy"), a.with_updates(delta=20),
            a.with_updates(zone_chunk=4), *_lattice_configs("ref")]
    got = planner.build_config_lattices(cfgs)
    want = j_planner.build_config_lattices([_jax(c) for c in cfgs])
    assert [(lat.indices, lat.params) for lat in got] == \
        [(lat.indices, lat.params) for lat in want]
    assert [lat.dominating.to_dict() for lat in got] == \
        [lat.dominating.to_dict() for lat in want]
    dom = planner.dominating_config(_lattice_configs("ref"))
    assert (dom.delta, dom.l_max, dom.omega) == (50, 4, 4)


# ---------------------------------------------------------------------------
# discover_many: co-mined == JAX co-mined == independent.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["dense", "bucketed"])
@pytest.mark.parametrize("backend", ["ref", "cuda", "numpy"])
def test_discover_many_matches_jax_and_independent(backend, layout):
    g = _graph()
    cfgs = _lattice_configs(backend, zone_layout=layout)
    eng = _engine(cfgs[0])
    results = eng.discover_many(g, cfgs)
    j_cfgs = [_jax(c) for c in cfgs]
    j_results = JaxEngine(j_cfgs[0]).discover_many(g, j_cfgs)
    assert len(results) == 4
    for cfg, res, j_res in zip(cfgs, results, j_results):
        assert res.counts == j_res.counts
        assert res.counts == _engine(cfg).discover(g).counts
        assert (res.delta, res.l_max) == (cfg.delta, cfg.l_max)
    stats = results[0].layout["execution"]
    j_stats = j_results[0].layout["execution"]
    assert stats["n_configs"] == 4
    if backend == "cuda":          # fused on a CPU device: the torch scan
        assert (stats["path"], j_stats["path"]) == ("fused_torch-multi",
                                                   "fused_xla-multi")
        stats = {k: v for k, v in stats.items() if k not in ("path",
                                                             "backend")}
        j_stats = {k: v for k, v in j_stats.items() if k in stats}
    assert stats == j_stats
    assert eng.stats.discover_many_calls == 1
    assert eng.stats.comined_configs == 4


def test_discover_many_shares_one_sweep():
    """One lattice = one Phase-1 expansion: the engine's launch counter
    after a 4-config co-mine equals one dominating discover's."""
    g = powerlaw_bursty(5)
    cfgs = _lattice_configs("ref")
    solo = _engine(planner.dominating_config(cfgs))
    solo.discover(g)
    eng = _engine(cfgs[0])
    eng.discover_many(g, cfgs)
    assert eng.stats.launches == solo.stats.launches > 1


@pytest.mark.parametrize("fused", ["on", "off"])
def test_discover_many_cuda_backend_on_both_paths(fused):
    g = powerlaw_bursty(7)
    cfgs = _lattice_configs("cuda", zone_layout="bucketed", fused=fused)
    results = _engine(cfgs[0]).discover_many(g, cfgs)
    stats = results[0].layout["execution"]
    n_buckets = len(results[0].layout["buckets"])
    if fused == "on":
        assert stats["path"] == "fused_torch-multi"
        assert stats["launches"] == 1
    else:
        assert stats["path"] == "per-bucket-multi"
        assert stats["launches"] == n_buckets > 1
    j_cfgs = [_jax(c) for c in cfgs]
    j_results = JaxEngine(j_cfgs[0]).discover_many(g, j_cfgs)
    for cfg, res, j_res in zip(cfgs, results, j_results):
        assert res.counts == j_res.counts
        ref_cfg = cfg.with_updates(backend="ref", fused="auto")
        assert res.counts == _engine(ref_cfg).discover(g).counts


def test_discover_many_mixed_lattices_and_order():
    """Incompatible configs split into lattices but results come back in
    input order, each still equal to its independent run."""
    g = _graph(seed=9, n=240)
    a = MiningConfig(delta=40, l_max=3, backend="ref")
    cfgs = [a, a.with_updates(backend="numpy"), a.with_updates(delta=15),
            a.with_updates(backend="numpy", l_max=2)]
    results = _engine(a).discover_many(g, cfgs)
    for cfg, res in zip(cfgs, results):
        assert res.counts == _engine(cfg).discover(g).counts
        assert (res.delta, res.l_max) == (cfg.delta, cfg.l_max)


@pytest.mark.parametrize("fused", ["on", "off"])
def test_discover_many_tiny_merge_cap_retries_like_jax(fused):
    """Per-member spill: only spilled members' caps double, and the retry
    converges to exact counts — with the JAX package's retry count."""
    g = _graph(seed=11)
    base = MiningConfig(delta=50, l_max=4, backend="cuda", merge_cap=8,
                        zone_chunk=4, fused=fused)
    cfgs = [base, base.with_updates(delta=20, l_max=3),
            base.with_updates(delta=50, l_max=2)]
    with pytest.warns(RuntimeWarning, match="co-mine.*spilled"):
        results = _engine(base).discover_many(g, cfgs)
    j_cfgs = [_jax(c) for c in cfgs]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        j_results = JaxEngine(j_cfgs[0]).discover_many(g, j_cfgs)
    stats = results[0].layout["execution"]
    j_stats = j_results[0].layout["execution"]
    assert stats["spill_retries"] == j_stats["spill_retries"] >= 1
    assert stats.get("merge_caps") == j_stats.get("merge_caps")
    for cfg, res, j_res in zip(cfgs, results, j_results):
        assert res.counts == j_res.counts
        solo = _engine(cfg.with_updates(merge_cap=None, zone_chunk=None))
        assert res.counts == solo.discover(g).counts


def test_discover_many_empty_single_and_undominated():
    g = _graph(seed=2, n=120)
    cfg = MiningConfig(delta=40, l_max=3, backend="ref")
    eng = _engine(cfg)
    assert eng.discover_many(g, []) == []
    [res] = eng.discover_many(g, [cfg])
    assert res.counts == eng.discover(g).counts
    ex = MiningExecutor(delta=40, l_max=3, device="cpu")
    layout = tzp.build_zone_layout(g, tzp.plan_zones(g, delta=40, l_max=3,
                                                     omega=20))
    with pytest.raises(ValueError, match="not dominated"):
        ex.run_layout_multi(layout, [(50, 3)])
    with pytest.raises(ValueError, match="at least one"):
        ex.run_layout_multi(layout, [])


def test_lattice_executors_are_warm_and_on_the_engine_device():
    g = _graph(seed=4, n=150)
    eng = _engine(MiningConfig(delta=30, l_max=3, backend="ref"))
    cfgs = _lattice_configs("ref")
    eng.discover_many(g, cfgs)
    eng.discover_many(g, cfgs)
    [ex] = eng._lattice_executors.values()
    assert ex.device == eng.device
    assert (ex.delta, ex.l_max) == (50, 4)
    assert eng.stats.discover_many_calls == 2
