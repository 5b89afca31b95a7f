"""The port's sharded mining (slice 6) against the JAX package.

The JAX package shards zones over a ``jax.sharding.Mesh`` in one process;
the port runs SPMD over ``torch.distributed`` ranks with a ``DeviceMesh``
(gloo on the CPU here).  One-rank cases run in this process on a
``FileStore`` world that each test destroys again; they mirror the JAX
package's one-device mesh tests.  The four-rank cases spawn four
processes as a ``(2, 2)`` mesh, once for the module, and hold each rank's
merged ``CodeCounts`` byte for byte against the JAX step on a four-device
CPU mesh (run in a subprocess with
``--xla_force_host_platform_device_count=4``, as ``test_system.py``
does); both must equal the brute-force oracle.

Tolerance: none for counts (exact); ``compressed_psum_int8`` is held to
the JAX test's 0.05 relative error of one stochastic draw.
"""

import os
import subprocess
import sys
import textwrap
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.core import MiningConfig as JaxConfig
from repro.core import MiningExecutor as JaxExecutor
from repro.core import PTMTEngine as JaxEngine
from repro.core import oracle as jax_oracle
from repro.core import tzp as jax_tzp
from repro.distributed import mining as jax_mining
from repro_torch.core import MiningConfig, MiningExecutor, PTMTEngine, tzp
from repro_torch.core import ZoneOverflowError, transitions
from repro_torch.core.convert import counts_to_numpy
from repro_torch.distributed import collectives, mining
from repro_torch.serving.cluster import ClusterCoordinator
from repro_torch.training import elastic
from conftest import random_graph
from torch_corpus import gloo_mesh, powerlaw_bursty

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(delta=60, l_max=3, omega=4)
PARAMS = dict(delta=50, l_max=3, omega=3)


def _jax_mesh():
    return jax.sharding.Mesh(np.array(jax.devices()[:1]), ("z",))


def _same(got, want):
    """Two count tables (either package) equal byte for byte."""
    for a, b in zip(counts_to_numpy(got), counts_to_numpy(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def _dict(c):
    return transitions.device_counts_to_dict(c)


# -- one rank, in this process ------------------------------------------------

def test_sharded_caches_mesh_step_and_matches_single_device(tmp_path):
    """``tests/test_engine.py``'s mesh case: the step is made once and
    reused, a first sharded run after a same-shaped ``discover`` traces
    as a first run (its execution key includes the step), and the counts
    equal ``discover``'s and the JAX package's."""
    from repro_torch import obs

    g = random_graph(11, 256, 10, 2_000)
    engine = PTMTEngine(MiningConfig(**CFG, zone_chunk=2), device="cpu",
                        obs=obs.enabled())
    engine.discover(g)
    with gloo_mesh(tmp_path) as mesh:
        a = engine.sharded(g, mesh, ("z",))
        b = engine.sharded(g, mesh, ("z",))
    phases = [ev["args"]["phase"] for ev in engine.obs.tracer.events()
              if ev["name"] == "mine.sharded"]
    n = len(a.layout["buckets"])
    assert phases == ["compile"] * n + ["exec"] * n
    assert a.counts == b.counts
    assert len(engine._mesh_steps) == 1      # step made once, reused
    assert engine.stats.sharded_calls == 2
    assert a.counts == PTMTEngine(MiningConfig(**CFG), device="cpu") \
        .discover(g).counts
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = JaxEngine(JaxConfig(**CFG, zone_chunk=2)).sharded(
            g, _jax_mesh(), ("z",))
    assert a.counts == want.counts


@pytest.mark.parametrize("merge_mode", ["flat", "hierarchical"])
def test_mine_on_mesh_equals_jax_step_byte_for_byte(tmp_path, merge_mode):
    g = powerlaw_bursty(5)
    d, lm, om = 12, 3, 2
    batch = tzp.build_zone_batch(g, tzp.plan_zones(g, delta=d, l_max=lm,
                                                   omega=om), pad_zones_to=2)
    jbatch = jax_tzp.build_zone_batch(
        g, jax_tzp.plan_zones(g, delta=d, l_max=lm, omega=om),
        pad_zones_to=2)
    with gloo_mesh(tmp_path) as mesh:
        fn = mining.make_mine_step(mesh, ("z",), delta=d, l_max=lm,
                                   zone_chunk=2, out_cap=512,
                                   merge_mode=merge_mode)
        got, ovf = fn(batch.u, batch.v, batch.t, batch.valid, batch.sign)
    jfn = jax_mining.make_mine_step(_jax_mesh(), ("z",), delta=d, l_max=lm,
                                    zone_chunk=2, out_cap=512,
                                    merge_mode=merge_mode)
    want, jovf = jfn(*(jax.numpy.asarray(x) for x in (
        jbatch.u, jbatch.v, jbatch.t, jbatch.valid, jbatch.sign)))
    assert int(ovf) == int(jovf) == 0
    _same(got, want)
    assert _dict(got) == dict(jax_oracle.count_codes(g.u, g.v, g.t, d, lm))


def test_mine_layout_on_mesh_matches_and_enforces_overflow(tmp_path):
    """``tests/test_zone_layout.py``'s mesh case: the bucketed layout
    mined on the mesh equals ``discover``; an overflowed layout raises,
    or warns with ``allow_overflow``."""
    g = powerlaw_bursty(7, n=300)
    cfg = MiningConfig(**PARAMS)
    plan = tzp.plan_zones(g, **PARAMS)
    lay = tzp.build_zone_layout(g, plan, layout="bucketed")
    tight = tzp.plan_zones(g, delta=PARAMS["delta"],
                           l_max=PARAMS["l_max"], omega=2, e_cap=4)
    tight_lay = tzp.build_zone_layout(g, tight, layout="bucketed", e_cap=4)
    assert tight_lay.overflow > 0
    with gloo_mesh(tmp_path) as mesh:
        counts = mining.mine_layout_on_mesh(lay, mesh, ("z",), config=cfg)
        with pytest.raises(ZoneOverflowError, match="bucket"):
            mining.mine_layout_on_mesh(tight_lay, mesh, ("z",), config=cfg)
        with pytest.warns(RuntimeWarning, match="dropped"):
            mining.mine_layout_on_mesh(tight_lay, mesh, ("z",), config=cfg,
                                       allow_overflow=True)
    expect = JaxEngine(JaxConfig(**PARAMS)).discover(g).counts
    assert _dict(counts) == expect


def test_mesh_hierarchical_matches_single_device(tmp_path):
    """``tests/test_differential.py``'s mesh case: the per-shard
    hierarchical fold on the mesh equals plain discovery."""
    g = powerlaw_bursty(7, n=120)
    delta, l_max = 20, 3
    plan = tzp.plan_zones(g, delta=delta, l_max=l_max, omega=2)
    batch = tzp.build_zone_batch(g, plan, pad_zones_to=4)
    with gloo_mesh(tmp_path) as mesh:
        ex = MiningExecutor(delta=delta, l_max=l_max, zone_chunk=2,
                            agg="hierarchical", device="cpu")
        counts = mining.mine_on_mesh(batch, mesh, ("z",), executor=ex)
    expect = JaxEngine(JaxConfig(delta=delta, l_max=l_max, omega=2)) \
        .discover(g).counts
    assert _dict(counts) == expect


def test_mesh_requires_device_backend(tmp_path):
    """``tests/test_executor.py``'s mesh case: a host-only backend is
    refused, and so is an executor on another device type than the
    mesh's."""
    with gloo_mesh(tmp_path) as mesh:
        with pytest.raises(ValueError, match="host-only"):
            mining.make_mine_fn(mesh, ("z",), delta=10, l_max=3,
                                backend="numpy")
        meta = MiningExecutor(delta=10, l_max=3, device="meta")
        with pytest.raises(ValueError, match="mesh on cpu"):
            mining.make_mine_fn(mesh, ("z",), executor=meta)
        with pytest.raises(ValueError, match="not dimensions"):
            mining.make_mine_fn(mesh, ("y",), delta=10, l_max=3)


def test_out_cap_overflow_raises(tmp_path):
    g = random_graph(3, 400, 12, 3_000)
    with gloo_mesh(tmp_path) as mesh:
        engine = PTMTEngine(MiningConfig(**CFG), device="cpu")
        with pytest.raises(RuntimeError, match="out_cap=4 at the collective"):
            engine.sharded(g, mesh, out_cap=4)
        for mode in ("flat", "hierarchical"):
            res = engine.sharded(g, mesh, merge_mode=mode)
            assert res.counts == engine.discover(g).counts


def test_input_specs():
    specs = mining.input_specs(8, 64)
    assert specs["u"] == ((8, 64), torch.int32)
    assert specs["valid"] == ((8, 64), torch.bool)
    assert specs["signs"] == ((8,), torch.int32)
    jspecs = jax_mining.input_specs(8, 64)
    for k, (shape, dtype) in specs.items():
        assert tuple(jspecs[k].shape) == shape
        assert np.dtype(jspecs[k].dtype).name == str(dtype).split(".")[1]


def test_cluster_worker_with_mesh_counts_equal_discover(tmp_path):
    g = random_graph(29, 300, 9, 1_200)
    cfg = MiningConfig(delta=20, l_max=4, omega=3, backend="cuda",
                       zone_chunk=2)
    with gloo_mesh(tmp_path) as mesh:
        co = ClusterCoordinator(1, config=cfg, device="cpu", mesh=mesh,
                                mesh_axes=("z",), ingest_batch=64)
        sharded = co.workers["w0"].sharded_mine(g)
    assert sharded.counts == PTMTEngine(cfg, device="cpu").discover(
        g).counts


def test_one_rank_collectives_and_elastic_mesh(tmp_path):
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    with gloo_mesh(tmp_path) as mesh:
        group = mesh.get_group("z")
        assert torch.equal(collectives.psum(x, group), x)
        assert torch.equal(collectives.all_gather_tiled(x, group), x)
        tree = collectives.psum_tree({"a": x, "b": [x * 2]}, group)
        assert torch.equal(tree["b"][0], x * 2)
        got = collectives.compressed_psum_int8(
            x, group, torch.Generator().manual_seed(0))
        assert float((got - x).abs().max()) <= 5.0 / 127 + 1e-6
        em = elastic.make_mesh_for(device_type="cpu")
        assert em.mesh_dim_names == ("data", "model")
        assert tuple(em.shape) == (1, 1)
        with pytest.raises(ValueError, match="covers 2 ranks"):
            elastic.make_mesh_for(2, device_type="cpu")
    moved = elastic.reshard({"a": x}, "cpu")
    assert torch.equal(moved["a"], x)


# -- four ranks, spawned --------------------------------------------------------

_RANK = """
import os, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.core import MiningConfig, PTMTEngine, tzp
from repro_torch.data import synthetic_graphs as sg
from repro_torch.distributed import collectives, mining

rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", store=dist.FileStore(store, 4), rank=rank,
                        world_size=4)
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("a", "b"))
g = sg.bursty_stream(1200, 18, seed=21)
delta, l_max = 90, 4
batch = tzp.build_zone_batch(g, tzp.plan_zones(g, delta=delta, l_max=l_max,
                                               omega=3),
                             pad_zones_to=8, n_shards=4)
res = {}
for mode in ("flat", "hierarchical"):
    fn = mining.make_mine_step(mesh, ("a", "b"), delta=delta, l_max=l_max,
                               out_cap=4096, merge_mode=mode)
    counts, ovf = fn(batch.u, batch.v, batch.t, batch.valid, batch.sign)
    res[mode + "_codes"] = counts.codes.numpy()
    res[mode + "_counts"] = counts.counts.numpy()
    res[mode + "_mask"] = counts.unique_mask.numpy()
    res[mode + "_overflow"] = np.asarray(int(ovf))
    eng = PTMTEngine(MiningConfig(delta=delta, l_max=l_max, omega=3,
                                  zone_chunk=2), device="cpu")
    sharded = eng.sharded(g, mesh, merge_mode=mode)
    res[mode + "_engine_equals_discover"] = np.asarray(
        sharded.counts == eng.discover(g).counts)
x = np.random.default_rng(0).standard_normal((4, 256)).astype(np.float32)
mine = torch.as_tensor(x[rank])
world = dist.group.WORLD
res["psum"] = collectives.psum(mine, world).numpy()
res["int8"] = collectives.compressed_psum_int8(
    mine, world, torch.Generator().manual_seed(rank)).numpy()
res["hier"] = collectives.hierarchical_psum(
    mine, mesh.get_group("b"), mesh.get_group("a")).numpy()
res["gather_b"] = collectives.all_gather_tiled(
    torch.tensor([rank]), mesh.get_group("b")).numpy()
res["gather_ab"] = collectives.all_gather_tiled(
    torch.tensor([rank]), mining.axes_group(mesh, ("a", "b"))).numpy()
res["coord"] = np.asarray(mining.shard_index(mesh, ("a", "b")))
np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
dist.destroy_process_group()
"""

_JAX = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, numpy as np
from repro.core import tzp
from repro.data import synthetic_graphs as sg
from repro.distributed import mining

g = sg.bursty_stream(1200, 18, seed=21)
delta, l_max = 90, 4
batch = tzp.build_zone_batch(g, tzp.plan_zones(g, delta=delta, l_max=l_max,
                                               omega=3),
                             pad_zones_to=8, n_shards=4)
mesh = jax.make_mesh((2, 2), ("a", "b"))
res = {}
for mode in ("flat", "hierarchical"):
    fn = mining.make_mine_step(mesh, ("a", "b"), delta=delta, l_max=l_max,
                               out_cap=4096, merge_mode=mode)
    counts, ovf = fn(*(jax.numpy.asarray(x) for x in (
        batch.u, batch.v, batch.t, batch.valid, batch.sign)))
    res[mode + "_codes"] = np.asarray(counts.codes)
    res[mode + "_counts"] = np.asarray(counts.counts)
    res[mode + "_mask"] = np.asarray(counts.unique_mask)
    res[mode + "_overflow"] = np.asarray(int(ovf))
np.savez(os.path.join(sys.argv[1], "jax.npz"), **res)
"""


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """Run the four gloo ranks and the JAX four-device step at once;
    returns ``(ranks, jax)``: each rank's saved arrays and the JAX
    step's."""
    out = tmp_path_factory.mktemp("four_ranks")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_RANK), str(r),
         str(out / "store"), str(out)], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(4)]
    procs.append(subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_JAX), str(out)], env=env,
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True))
    for p in procs:
        log, _ = p.communicate(timeout=240)
        assert p.returncode == 0, log[-3000:]
    ranks = [dict(np.load(out / f"rank{r}.npz")) for r in range(4)]
    return ranks, dict(np.load(out / "jax.npz"))


@pytest.mark.parametrize("mode", ["flat", "hierarchical"])
def test_four_rank_mesh_equals_jax_step_byte_for_byte(four_ranks, mode):
    from repro.data import synthetic_graphs as jax_sg

    ranks, want = four_ranks
    g = jax_sg.bursty_stream(1200, 18, seed=21)
    expect = dict(jax_oracle.count_codes(g.u, g.v, g.t, 90, 4))
    for r, got in enumerate(ranks):
        assert int(got[mode + "_overflow"]) == 0
        for part in ("_codes", "_counts", "_mask"):
            a, b = got[mode + part], want[mode + part]
            assert a.dtype == b.dtype and a.shape == b.shape, (r, part)
            assert a.tobytes() == b.tobytes(), (r, part)
        assert transitions.counts_to_dict(
            got[mode + "_codes"], got[mode + "_counts"],
            got[mode + "_mask"]) == expect
        assert bool(got[mode + "_engine_equals_discover"])


def test_four_rank_collectives(four_ranks):
    ranks, _ = four_ranks
    x = np.random.default_rng(0).standard_normal((4, 256)).astype(np.float32)
    exact = x.sum(0)
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["psum"], exact, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got["hier"], exact, rtol=1e-6, atol=1e-6)
        # rank r is at (a, b) = divmod(r, 2): its "b" group is {2a, 2a+1}
        a = r // 2
        assert got["gather_b"].tolist() == [2 * a, 2 * a + 1]
        assert got["gather_ab"].tolist() == [0, 1, 2, 3]
        assert int(got["coord"]) == r
    # one stochastic draw per rank, as the JAX test takes
    q = ranks[0]["int8"]
    err = np.abs(q - exact).max() / (np.abs(exact).max() + 1e-9)
    assert err < 0.05, err
    for got in ranks[1:]:            # the result is replicated
        np.testing.assert_array_equal(got["int8"], q)
