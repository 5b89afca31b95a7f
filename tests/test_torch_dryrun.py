"""The port's dry run (slice 10) against the JAX package: the cell list,
the workloads' stand-ins and model FLOPs, the mining terms, the roofline,
and ``run_cell`` on a fake process group.

- ``all_cells()``: JAX's 44 cells, in order.
- ``model_flops`` and every ``in_sds`` shape and dtype of each LM and
  mining cell at CONFIG against JAX's ``Workload``, built (not compiled)
  on a (2, 2, 2) mesh: JAX's in a subprocess with 8 virtual devices, as
  ``tests/test_dryrun_smoke.py`` does; the port's on a fake world of 8.
- ``analytic_mining_terms`` for each ``MiningShape`` x 1, 8, 256, 512
  chips, and ``roofline`` given the JAX package's constants.
- ``run_cell`` on the LM and mining cases of ``tests/test_dryrun_smoke.py``
  at their smoke shapes: every record has the JAX record's keys,
  ``"status": "ok"``, FLOPs per rank > 0 and ``useful_flops_ratio`` <= 1.
  DTensor's first call of each op signature costs far more on a 3-D mesh
  than on a 2-D one, so one case runs on (2, 2, 2) and the rest on (2, 2).
- A GNN and a DCN-v2 cell on a (2, 2) mesh trace: unsharded their FLOPs
  equal ``FlopCounterMode``'s, B4's and B5's custom ops counted by their
  formulas; sharded, the four ranks do at least the unsharded work.
  ``orchestrate`` leaves an error record naming the item of a cell that
  fails (a bad ``--override``).
"""

import ast
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro.configs import all_cells as jax_all_cells
from repro.configs import ptmt as jax_ptmt
from repro.launch import analysis as jax_analysis
from repro_torch.configs import all_cells, common, get_arch, ptmt
from repro_torch.configs.common import LMShape
from repro_torch.configs.dcn_v2 import RecsysShape
from repro_torch.configs.gnn_common import GNNShape
from repro_torch.configs.ptmt import MiningShape
from repro_torch.launch import analysis, dryrun

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM = ["granite-8b", "gemma3-1b", "qwen2-72b", "moonshot-v1-16b-a3b",
      "arctic-480b"]

_JAX_WORKLOADS = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, sys
import jax
from repro.configs import get_arch
from repro.launch.mesh import make_test_mesh

mesh = make_test_mesh((2, 2, 2), ("pod", "data", "model"))
out = {}
for name in %r:
    arch = get_arch(name)
    for shape in arch.shapes:
        wl = arch.workload(shape.name, mesh)
        out[f"{name}/{shape.name}"] = {
            "name": wl.name, "kind": wl.kind,
            "model_flops": wl.model_flops,
            "in_sds": [[list(x.shape), str(x.dtype)]
                       for x in jax.tree.leaves(wl.in_sds)]}
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def jax_workloads(tmp_path_factory):
    path = tmp_path_factory.mktemp("dryrun") / "jax.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_WORKLOADS % (LM + ["ptmt-mining"]),
         str(path)], env=env, cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(path) as f:
        return json.load(f)


@pytest.fixture
def fake_mesh():
    """A (2, 2, 2) mesh on a fake world of 8 ranks in this process."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_lib

    mesh_lib.fake_world(8)
    try:
        yield mesh_lib.make_test_mesh((2, 2, 2), ("pod", "data", "model"))
    finally:
        dist.destroy_process_group()


def test_all_cells_match_jax():
    assert all_cells() == jax_all_cells()
    assert len(all_cells()) == 44
    assert all_cells(include_mining=False) == jax_all_cells(
        include_mining=False)


@pytest.mark.parametrize("name", LM + ["ptmt-mining"])
def test_workloads_match_jax(jax_workloads, fake_mesh, name):
    from repro_torch.training.tree import leaves

    arch = get_arch(name)
    for shape in arch.shapes:
        want = jax_workloads[f"{name}/{shape.name}"]
        wl = arch.workload(shape.name, fake_mesh)
        assert (wl.name, wl.kind) == (want["name"], want["kind"])
        assert wl.model_flops == want["model_flops"]
        got = [[list(x.shape), str(x.dtype).split(".")[-1]]
               for x in leaves(wl.in_sds)]
        assert got == want["in_sds"], shape.name
        assert {x.device.type for x in leaves(wl.in_sds)} == {"meta"}
        if arch.family == "lm":
            assert len(leaves(wl.in_shardings)) == len(got)


@pytest.mark.parametrize("n_chips", [1, 8, 256, 512])
def test_analytic_mining_terms_match_jax(n_chips):
    for shape, jshape in zip(ptmt.MINING_SHAPES, jax_ptmt.MINING_SHAPES):
        for cfg, jcfg in ((ptmt.CONFIG, jax_ptmt.CONFIG),
                          (ptmt.SMOKE, jax_ptmt.SMOKE)):
            assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
            assert dataclasses.asdict(shape) == dataclasses.asdict(jshape)
            assert ptmt.analytic_mining_terms(cfg, shape, n_chips) == \
                jax_ptmt.analytic_mining_terms(jcfg, jshape, n_chips)


def test_roofline_matches_jax_given_its_constants(monkeypatch):
    monkeypatch.setattr(analysis, "PEAK_FLOPS", jax_analysis.PEAK_FLOPS)
    monkeypatch.setattr(analysis, "HBM_BW", jax_analysis.HBM_BW)
    monkeypatch.setattr(analysis, "LINK_BW", jax_analysis.ICI_BW)
    rng = np.random.default_rng(0)
    for peak in (None, jax_analysis.VPU_PEAK):
        for _ in range(20):
            rec = {"flops_per_chip": float(rng.uniform(0, 1e13)),
                   "bytes_per_chip": float(rng.uniform(0, 1e10)),
                   "collective_bytes_per_chip": float(rng.uniform(0, 1e9)),
                   "n_chips": int(rng.choice([1, 8, 256, 512])),
                   "model_flops": float(rng.uniform(0, 1e15))}
            if peak is not None:
                rec["peak_flops"] = peak
            assert analysis.roofline(rec) == jax_analysis.roofline(rec)


def test_collective_bytes_weighs_as_jax():
    recs = [("all-gather", 2048 * 512 * 2), ("all-reduce", 1024 * 4),
            ("reduce-scatter", 1024 * 64 * 4), ("collective-permute", 256),
            ("all-to-all", 64 * 32 * 4)]
    hlo = """
  %ag = bf16[2048,512]{1,0} all-gather(bf16[128,512]{1,0} %x), dims={0}
  %ar = f32[1024]{0} all-reduce(f32[1024]{0} %y), to_apply=%sum
  %rs = f32[128,64]{1,0} reduce-scatter(f32[1024,64]{1,0} %z), dims={0}
  %cp = u8[256]{0} collective-permute(u8[256]{0} %w)
  %a2a = s32[64,32]{1,0} all-to-all(s32[64,32]{1,0} %v), dims={0}
"""
    assert analysis.collective_bytes(recs) == \
        jax_analysis.collective_bytes(hlo)


def _jax_record_keys() -> set:
    """The keys of the JAX dry run's record: its ``record`` literal and
    what ``roofline`` adds."""
    tree = ast.parse(open(os.path.join(
        ROOT, "src", "repro", "launch", "dryrun.py")).read())
    keys = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", "") == "record"
                        for t in node.targets)):
            keys |= {k.value for k in node.value.keys}
    rec = {"flops_per_chip": 1.0, "bytes_per_chip": 1.0,
           "collective_bytes_per_chip": 1.0, "n_chips": 1,
           "model_flops": 1.0}
    return keys | set(jax_analysis.roofline(rec))


#: the LM and mining cases of tests/test_dryrun_smoke.py, with the mesh
#: each runs on here
CASES = [
    ("granite-8b", LMShape("train_4k", 256, 16, "train"), (2, 2)),
    ("gemma3-1b", LMShape("prefill_32k", 2048, 4, "prefill"), (2, 2)),
    ("qwen2-72b", LMShape("decode_32k", 2048, 8, "decode"), (2, 2, 2)),
    ("moonshot-v1-16b-a3b", LMShape("train_4k", 128, 8, "train"), (2, 2)),
    ("arctic-480b", LMShape("long_500k", 16384, 1, "decode"), (2, 2)),
    ("ptmt-mining", MiningShape("mine_sm", 64, 256), (2, 2)),
]


@pytest.mark.parametrize("name,shape,mesh", CASES,
                         ids=[c[0] for c in CASES])
def test_run_cell_writes_an_ok_record(tmp_path, name, shape, mesh):
    rec = dryrun.run_cell(name, shape.name, "test", str(tmp_path),
                          shape=shape, smoke=True, mesh_shape=mesh)
    path = dryrun.cell_path(str(tmp_path), name, shape.name, "test")
    with open(path) as f:
        assert json.load(f) == json.loads(json.dumps(rec))
    assert _jax_record_keys() <= set(rec)
    assert rec["status"] == "ok"
    assert rec["n_chips"] == int(np.prod(mesh))
    assert rec["flops_per_chip"] > 0
    assert rec["flops_per_chip"] == rec["flops_per_chip_raw"]
    assert rec["scan_calibrated"] is False
    assert 0 < rec["useful_flops_ratio"] <= 1
    assert rec["fits_h100"] is True
    assert rec["peak_bytes_per_chip"] >= rec["memory"]["argument_bytes"]
    if name != "ptmt-mining":
        # a sharded step moves data between the ranks
        assert rec["collective_bytes_per_chip"] > 0


#: one cell of each kind at smoke size, for the FLOP cross-checks
KINDS = [LMShape("prefill_32k", 256, 4, "prefill"),
         LMShape("decode_32k", 256, 8, "decode"),
         LMShape("train_4k", 128, 8, "train")]


@pytest.mark.parametrize("name", LM)
def test_rank_flops_against_an_independent_count(tmp_path, name):
    """The dry run's FLOPs held against counts it does not make itself.
    Unsharded (a one-device mesh), ``RankCounter``'s count of a step is
    ``FlopCounterMode``'s, torch's own counter through its own dispatch,
    for a prefill, a decode and a training cell at smoke size.  On the
    (2, 2) mesh the four ranks together do at least the unsharded work,
    and a dense prefill or training step exactly that work plus the K/V
    projections replicated over "model" where the KV heads do not divide
    it (gemma3's one KV head; forward, and in training the two backward
    matmuls): the resolver's choice, the JAX package's too.  A decode
    step and the MoE do more (the MoE's one token group at smoke size
    rides no batch axis, so each "data" rank dispatches all of it, as
    the JAX layout does; ``test_sharded_decode_does_the_unsharded_work``
    holds the dense decode)."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    arch = get_arch(name)
    cfg = arch.smoke_config
    for shape in KINDS:
        one = dryrun.run_cell(name, shape.name, "one", str(tmp_path),
                              shape=shape, smoke=True, mesh_shape=(1,))
        wl = arch.workload_fn(cfg, shape, None)
        with FakeTensorMode():
            args = dryrun.local_args(wl, shape, lambda d, t: torch.empty(
                d, dtype=t))
            with FlopCounterMode(display=False) as fc:
                wl.fn(*args)
        assert one["flops_per_chip"] == fc.get_total_flops() > 0, shape
        four = dryrun.run_cell(name, shape.name, "four", str(tmp_path),
                               shape=shape, smoke=True, mesh_shape=(2, 2))
        assert 4 * four["flops_per_chip"] >= one["flops_per_chip"], shape
        if shape.kind != "decode" and not cfg.moe:
            assert cfg.remat == "none"      # no recompute to count
            kv = (2 * shape.global_batch * shape.seq_len * cfg.d_model
                  * cfg.n_kv_heads * cfg.d_head * 2 * cfg.n_layers)
            passes = 3 if shape.kind == "train" else 1
            extra = passes * kv if cfg.n_kv_heads % 2 else 0
            assert 4 * four["flops_per_chip"] == \
                one["flops_per_chip"] + extra, shape


@pytest.mark.parametrize("name", ["granite-8b", "gemma3-1b", "qwen2-72b"])
def test_sharded_decode_does_the_unsharded_work(tmp_path, name):
    """On (2, 2) the four ranks of a dense decode step do exactly the
    unsharded step's FLOPs plus the K/V projections replicated over
    "model" where the KV heads do not divide it (gemma3's one KV head),
    the check ``test_rank_flops_against_an_independent_count`` makes of a
    prefill and a training step.  Without the reduction of the attention
    and MLP outputs over "model" into the residual stream, DTensor split
    the stream by rows over "model" and the next projections ran on whole
    weights (granite-8b: 7.3% more work)."""
    cfg = get_arch(name).smoke_config
    shape = KINDS[1]
    assert shape.kind == "decode" and not cfg.moe
    one, four = (dryrun.run_cell(name, shape.name, tag, str(tmp_path),
                                 shape=shape, smoke=True, mesh_shape=mesh)
                 for tag, mesh in (("one", (1,)), ("four", (2, 2))))
    kv = (2 * shape.global_batch * cfg.d_model * cfg.n_kv_heads
          * cfg.d_head * 2 * cfg.n_layers)
    extra = kv if cfg.n_kv_heads % 2 else 0
    assert 4 * four["flops_per_chip"] == one["flops_per_chip"] + extra > 0


@pytest.mark.parametrize("name,shape", [
    ("gat-cora", GNNShape("full_graph_sm", 512, 2048, 16, 4)),
    ("dcn-v2", RecsysShape("train_batch", 1024, "train")),
    ("gin-tu", GNNShape("molecule", 240, 512, 16, 3, n_graphs=8)),
    ("equiformer-v2", GNNShape("molecule", 240, 512, 16, 1, n_graphs=8)),
    ("dcn-v2", RecsysShape("retrieval_cand", 2, "retrieval",
                           n_candidates=512)),
])
def test_gnn_and_dcn_cells_trace_on_a_mesh(tmp_path, name, shape):
    """The cells trace on (2, 2) (records ``"ok"``, collectives moved).
    Unsharded, ``RankCounter``'s FLOPs are ``FlopCounterMode``'s, torch's
    own counter through its own dispatch, which counts B4's and B5's
    custom ops by their registered formulas; on (2, 2) the four ranks do
    at least the unsharded work (edges and batch rows split over "data",
    the per-edge work and the lookups repeated on each "model" rank)."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    arch = get_arch(name)
    one = dryrun.run_cell(name, shape.name, "one", str(tmp_path),
                          shape=shape, smoke=True, mesh_shape=(1,))
    wl = arch.workload_fn(arch.smoke_config, shape, None)
    with FakeTensorMode():
        args = dryrun.local_args(wl, shape, lambda d, t: torch.empty(
            d, dtype=t))
        with FlopCounterMode(display=False) as fc:
            wl.fn(*args)
    assert one["flops_per_chip"] == fc.get_total_flops() > 0
    four = dryrun.run_cell(name, shape.name, "test", str(tmp_path),
                           shape=shape, smoke=True, mesh_shape=(2, 2))
    assert four["status"] == "ok" and four["collective_bytes_per_chip"] > 0
    assert 4 * four["flops_per_chip"] >= one["flops_per_chip"]


def test_orchestrate_writes_error_records_naming_the_item(tmp_path,
                                                          monkeypatch):
    cells = [("gat-cora", "full_graph_sm", "single"),
             ("dcn-v2", "serve_p99", "multi")]
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    # no config has this field: each cell fails, naming it
    item = "no_such_field"
    # the two cells end in either order; failures come in the cells' order
    failures = dryrun.orchestrate(str(tmp_path), cells=cells, jobs=2,
                                  tag="l2", n_layers=2,
                                  overrides=f"{item}=1")
    assert failures == cells
    for a, s, m in cells:
        with open(dryrun.cell_path(str(tmp_path), a, s, m, "l2")) as f:
            rec = json.load(f)
        assert rec["status"] == "error" and item in rec["stderr"]


def test_production_mesh_needs_its_world():
    from repro_torch.launch import mesh as mesh_lib

    with pytest.raises(RuntimeError, match="dry run"):
        mesh_lib.make_production_mesh()
    assert mesh_lib.production_shape(True) == ((2, 16, 16),
                                               ("pod", "data", "model"))
    # every arch runs on a mesh: nothing refuses one
    assert not hasattr(common, "no_mesh")


@pytest.mark.parametrize("name", ["granite-8b", "moonshot-v1-16b-a3b"])
def test_real_run_counts_what_the_dry_run_counts(tmp_path, monkeypatch,
                                                 name):
    """``run_real`` (rank 0 of a fake world, real tensors of a rank's
    size, here on the CPU) counts exactly the FLOPs and collectives the
    dry run counts on fake tensors, for a decode and a training cell: the
    check ``chip_smoke.py`` phase 17 (c) makes on the card.  The smoke
    config on small shapes and a (2, 2) mesh stand in for the full ones."""
    import repro_torch.configs as configs
    from repro_torch.launch import mesh as mesh_lib

    orig = configs.get_arch
    shapes = (LMShape("train_4k", 64, 8, "train"),
              LMShape("decode_32k", 64, 8, "decode"))
    monkeypatch.setattr(configs, "get_arch", lambda n: dataclasses.replace(
        orig(n), config=orig(n).smoke_config, shapes=shapes))
    monkeypatch.setattr(mesh_lib, "production_shape",
                        lambda multi=False: ((2, 2), ("data", "model")))
    for shape in ("decode_32k", "train_4k"):
        real = dryrun.run_real(name, shape, n_layers=2, device="cpu")
        rec = dryrun.run_cell(name, shape, "single", str(tmp_path),
                              n_layers=2)
        assert real["flops"] == rec["flops_per_chip"] > 0
        assert real["collectives"] == sum(rec["collectives"].values()) > 0
        assert real["peak_bytes"] is None      # measured on a card only


@pytest.mark.parametrize("name,shape", [
    ("gin-tu", GNNShape("minibatch_lg", 240, 512, 16, 3)),
    ("gat-cora", GNNShape("full_graph_sm", 240, 512, 16, 4)),
    ("equiformer-v2", GNNShape("molecule", 240, 512, 16, 1, n_graphs=8)),
    ("dcn-v2", RecsysShape("train_batch", 64, "train")),
])
def test_real_graph_run_counts_what_the_dry_run_counts(tmp_path,
                                                       monkeypatch, name,
                                                       shape):
    """``run_real`` of the cells ``chip_smoke.py`` phase 17 (c) holds on
    the card, whole (``n_layers=None``), here on the CPU at smoke size on
    a (2, 2) mesh: the FLOPs and collectives of the dry run exactly; the
    CPU launches no kernel."""
    import repro_torch.configs as configs
    from repro_torch.launch import mesh as mesh_lib

    orig = configs.get_arch
    monkeypatch.setattr(configs, "get_arch", lambda n: dataclasses.replace(
        orig(n), config=orig(n).smoke_config, shapes=(shape,)))
    monkeypatch.setattr(mesh_lib, "production_shape",
                        lambda multi=False: ((2, 2), ("data", "model")))
    real = dryrun.run_real(name, shape.name, n_layers=None, device="cpu")
    rec = dryrun.run_cell(name, shape.name, "single", str(tmp_path))
    assert real["flops"] == rec["flops_per_chip"] > 0
    assert real["collectives"] == sum(rec["collectives"].values()) > 0
    assert real["launches"] == {} and real["peak_bytes"] is None
