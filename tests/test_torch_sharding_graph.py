"""The GNN archs, equiformer-v2 and DCN-v2 on a real four-rank mesh against
the JAX package: gin-tu (graph readout), gat-cora and gatedgcn (node
readout), equiformer-v2 (graph regression) and DCN-v2 at their SMOKE
configs on a 2-D gloo (2, 2) mesh of four CPU ranks, started once per
module as subprocesses.

Parameters are made by the JAX package's ``tree_init`` and carried across
with ``convert.params_from_numpy``; graphs and batches come from the same
numpy seeds (a 48-node, 160-edge graph padded to 56 nodes and 200 edges,
gatedgcn's nodes unpadded as in ``test_torch_training.py``: the JAX
gradient of ``wu`` is NaN at a zero-variance pad row).  On rank 0, laid
out by the workloads' own shardings:

- ``forward`` and ``loss_fn`` against the JAX package's unsharded ones;
- one step of ``gnn_workload``'s or ``recsys_workload``'s training step
  (``value_and_grad`` and AdamW): the loss, AdamW's moments and the new
  parameters, against the JAX step on a one-device mesh;
- DCN-v2's ``serve`` and ``retrieval`` workload steps (logits; top scores
  and ids), and DCN-v2 once more with its last vocabulary odd (21), so
  that table stays replicated on "model" and the lookup of the rank at
  coordinate 0 serves it;
- every ``constrain`` call of ``forward`` (and of DCN-v2's retrieval):
  spec and shape equal the JAX package's calls, recorded on a stand-in
  (2, 2) mesh with ``jax.eval_shape`` (a scanned layer's calls once; the
  port runs every layer), and the placements each call leaves are the
  ones JAX's ``resolve`` gives that spec.

Tolerances, those ``tests/test_torch_models.py`` and
``tests/test_torch_training.py`` state for the unsharded port: model
outputs and losses rtol 1e-4 with an atol of 1e-4 x the largest
magnitude; gradients' AdamW moments the same; the parameters after a step
rtol 1e-5 with an atol of 1e-5 x the largest magnitude.  The partial sums
add each node's in-edges in two parts (one per "data" rank) and then the
parts, so the order of summation differs from the unsharded one; measured
here, the largest difference from the JAX package over all 247 compared
arrays is 1.8e-5 of that array's largest magnitude, within the
tolerances above.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import dcn_v2 as jax_dcn
from repro.configs import get_arch as jax_get_arch
from repro.configs import gnn_common as jax_gnn_common
from repro.data import graph_data as jax_graph_data
from repro.models import equiformer as jax_eq
from repro.models import gnn as jax_gnn
from repro.models import params as jax_params
from repro.models import recsys as jax_recsys
from repro.models import sharding as jax_shd
from repro.training import optimizer as jax_optimizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL, STEP_TOL = 1e-4, 1e-5
N, E, F_IN, PAD_N, PAD_E = 48, 160, 12, 56, 200
B, B_Q, N_CAND, TOP_K = 16, 2, 64, 10
#: arch -> (readout, classes, graphs, pad the nodes)
GNN = {"gin-tu": ("graph", 3, 4, True),
       "gat-cora": ("node", 5, 0, True),
       "gatedgcn": ("node", 5, 0, False),
       "equiformer-v2": ("graph", 1, 4, True)}
DCN = {"dcn-v2": None, "dcn-v2-odd": (100, 100, 50, 50, 20, 21)}
ARCHS = [*GNN, *DCN]


def _standin():
    return types.SimpleNamespace(shape={"data": 2, "model": 2})


def _spec_list(p):
    return [list(e) if isinstance(e, tuple) else e for e in p]


def _flat(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _sites(fn):
    """The JAX package's ``constrain`` calls while ``fn`` is traced on the
    stand-in mesh, each ``[spec, shape, resolved spec]``."""
    log = []

    def record(x, mesh, *spec):
        log.append([_spec_list(spec), list(x.shape),
                    _spec_list(jax_shd.resolve(spec, x.shape, mesh))])
        return x

    plain, jax_shd.constrain = jax_shd.constrain, record
    try:
        jax.eval_shape(fn)
    finally:
        jax_shd.constrain = plain
    return log


def _one_device_mesh():
    return jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))


def _graph_kw(name):
    readout, classes, graphs, pad = GNN[name]
    return dict(n_nodes=N, n_edges=E, d_feat=F_IN, n_classes=classes,
                n_graphs=graphs, with_positions=name == "equiformer-v2",
                seed=11, pad_nodes=PAD_N if pad else 0, pad_edges=PAD_E)


def _jax_gnn(name, out):
    kw = _graph_kw(name)
    n_nodes = max(kw["n_nodes"], kw["pad_nodes"])
    shape = jax_gnn_common.GNNShape("tiny", n_nodes, PAD_E, F_IN,
                                    kw["n_classes"], n_graphs=kw["n_graphs"])
    arch = jax_get_arch(name)
    jcfg = jax_gnn_common._specialize(arch.smoke_config, shape)
    model = jax_eq if name == "equiformer-v2" else jax_gnn
    specs = (jax_eq.equiformer_param_specs(jcfg) if model is jax_eq
             else jax_gnn.gnn_param_specs(jcfg))
    jp = jax_params.tree_init(jax.random.PRNGKey(0), specs)
    g = jax_graph_data.random_graph_batch(**kw)
    np.savez(out / f"{name}.npz", **_flat(jp))
    with open(out / f"{name}.json", "w") as f:
        json.dump({"graph": kw, "shape": [n_nodes, PAD_E, F_IN,
                                          kw["n_classes"], kw["n_graphs"]]},
                  f)
    want = {"logits": jax.jit(lambda p_, g_: model.forward(p_, g_, jcfg))(
        jp, g), "loss": jax.jit(lambda p_, g_: model.loss_fn(
            p_, g_, jcfg))(jp, g)}
    jw = jax_gnn_common.gnn_workload(arch.smoke_config, shape,
                                     _one_device_mesh())
    new_p, new_o, m = jax.jit(jw.fn)(jp, jax_optimizer.init_state(jp), g)
    want.update(step_loss=m["loss"], new=_flat(new_p), mu=_flat(new_o.mu),
                nu=_flat(new_o.nu))
    want["sites"] = {"forward": _sites(lambda: model.forward(
        jp, g, jcfg, _standin()))}
    return want


def _dcn_cfg(name):
    cfg = dataclasses.replace(jax_get_arch("dcn-v2").smoke_config,
                              use_pallas=False)
    if DCN[name]:
        cfg = dataclasses.replace(cfg, vocab_sizes=DCN[name])
    return cfg


def _dcn_batch(cfg, b, seed):
    # test_torch_training.py's batch: negative ids down to -V/4 wrap
    rng = np.random.default_rng(seed)
    return {
        "dense": rng.standard_normal((b, cfg.n_dense)).astype(np.float32),
        "sparse_ids": np.stack([rng.integers(-(v // 4), v, (b, cfg.bag_size))
                                for v in cfg.vocab_sizes], 1).astype(
                                    np.int32),
        "sparse_weights": rng.uniform(0.0, 1.0, (
            b, cfg.n_sparse, cfg.bag_size)).astype(np.float32),
        "labels": rng.integers(0, 2, b).astype(np.float32),
    }


def _jax_dcn(name, out):
    jcfg = _dcn_cfg(name)
    jp = jax_params.tree_init(jax.random.PRNGKey(0),
                              jax_recsys.dcn_param_specs(jcfg))
    batch = _dcn_batch(jcfg, B, 0)
    query = {k: v for k, v in _dcn_batch(jcfg, B_Q, 1).items()
             if k != "labels"}
    cand = np.random.default_rng(2).permutation(jcfg.n_items)[
        :N_CAND].astype(np.int32)
    np.savez(out / f"{name}.npz", **_flat(jp))
    np.savez(out / f"{name}.batch.npz", cand=cand, **batch,
             **{f"q_{k}": v for k, v in query.items()})
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = {"logits": jax_recsys.forward(jp, jb, jcfg),
            "loss": jax_recsys.loss_fn(jp, jb, jcfg)}
    shape = jax_dcn.RecsysShape("tiny", B, "train")
    jw = jax_dcn.recsys_workload(jcfg, shape, _one_device_mesh())
    new_p, new_o, m = jax.jit(jw.fn)(jp, jax_optimizer.init_state(jp), jb)
    want.update(step_loss=m["loss"], new=_flat(new_p), mu=_flat(new_o.mu),
                nu=_flat(new_o.nu))
    jq = {k: jnp.asarray(v) for k, v in query.items()}
    want["top_s"], want["top_i"] = jax_recsys.retrieval_step(
        jp, jq, jnp.asarray(cand), jcfg, top_k=TOP_K)
    want["sites"] = {
        "forward": _sites(lambda: jax_recsys.forward(jp, jb, jcfg,
                                                     _standin())),
        "retrieval": _sites(lambda: jax_recsys.retrieval_step(
            jp, jq, jnp.asarray(cand), jcfg, _standin(), top_k=TOP_K))}
    return want


_RANK = """
import dataclasses, json, os, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Shard

rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", store=dist.FileStore(store, 4), rank=rank,
                        world_size=4)
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))

from repro_torch.configs import dcn_v2, get_arch, gnn_common
from repro_torch.core import convert
from repro_torch.data import graph_data
from repro_torch.models import equiformer, gnn, recsys, sharding as shd
from repro_torch.training import optimizer
from repro_torch.training.tree import flatten_with_paths

sites = None
plain_constrain = shd.constrain


def entry(e):
    return list(e) if isinstance(e, tuple) else e


def laid_out(y):
    names = y.device_mesh.mesh_dim_names
    res = []
    for d in range(y.ndim):
        axes = [n for n, q in zip(names, y.placements) if q == Shard(d)]
        res.append(entry(tuple(axes)) if len(axes) > 1 else
                   axes[0] if axes else None)
    return res


def constrain(x, mesh_, *spec):
    y = plain_constrain(x, mesh_, *spec)
    if sites is not None:
        sites.append([[entry(e) for e in spec], list(y.shape), laid_out(y)])
    return y


shd.constrain = constrain


def full(x):
    return (x.full_tensor() if isinstance(x, DTensor) else x).detach() \\
        .to(torch.float32).numpy()


def nest(flat):
    tree = {{}}
    for path, v in flat.items():
        *head, last = path.split("/")
        node = tree
        for k in head:
            node = node.setdefault(k, {{}})
        node[last] = v
    return tree


def params_of(name):
    return convert.params_from_numpy(
        nest(dict(np.load(os.path.join(out, name + ".npz")))), "cpu")


def keep(name, new_p, new_o, metrics):
    res[name + "/step_loss"] = full(metrics["loss"])
    for part, tree in (("new", new_p), ("mu", new_o.mu), ("nu", new_o.nu)):
        for path, x in flatten_with_paths(tree):
            res[name + "/" + part + "/" + path] = full(x)


res, site_log = {{}}, {{}}
for name in {gnn!r}:
    with open(os.path.join(out, name + ".json")) as f:
        meta = json.load(f)
    n, e, d, classes, graphs = meta["shape"]
    shape = gnn_common.GNNShape("tiny", n, e, d, classes, n_graphs=graphs)
    arch = get_arch(name)
    cfg = gnn_common._specialize(arch.smoke_config, shape)
    model = equiformer if name == "equiformer-v2" else gnn
    params = params_of(name)
    g = graph_data.random_graph_batch(**meta["graph"], device="cpu")
    wl = gnn_common.gnn_workload(arch.smoke_config, shape, mesh)
    p, o, b = wl.place((params, optimizer.init_state(params), g))
    sites = site_log[name + "/forward"] = []
    res[name + "/logits"] = full(model.forward(p, b, cfg, mesh))
    sites = None
    res[name + "/loss"] = full(model.loss_fn(p, b, cfg, mesh))
    keep(name, *wl.fn(p, o, b))

for name, vocabs in {dcn!r}.items():
    cfg = get_arch("dcn-v2").smoke_config
    if vocabs:
        cfg = dataclasses.replace(cfg, vocab_sizes=tuple(vocabs))
    params = params_of(name)
    data = {{k: torch.as_tensor(v) for k, v in np.load(
        os.path.join(out, name + ".batch.npz")).items()}}
    cand = data.pop("cand")
    query = {{k[2:]: data.pop(k) for k in list(data) if k.startswith("q_")}}
    train = dcn_v2.recsys_workload(
        cfg, dcn_v2.RecsysShape("tiny", {b}, "train"), mesh)
    p, o, b = train.place((params, optimizer.init_state(params), data))
    sites = site_log[name + "/forward"] = []
    res[name + "/logits"] = full(recsys.forward(p, b, cfg, mesh))
    sites = None
    res[name + "/loss"] = full(recsys.loss_fn(p, b, cfg, mesh))
    keep(name, *train.fn(p, o, b))
    serve = dcn_v2.recsys_workload(
        cfg, dcn_v2.RecsysShape("tiny", {b}, "serve"), mesh)
    served = {{k: v for k, v in data.items() if k != "labels"}}
    res[name + "/serve"] = full(serve.fn(*serve.place((params, served))))
    ret = dcn_v2.recsys_workload(cfg, dcn_v2.RecsysShape(
        "tiny", {b_q}, "retrieval", n_candidates={n_cand}), mesh)
    args = ret.place((params, query, cand))
    sites = site_log[name + "/retrieval"] = []
    top_s, top_i = recsys.retrieval_step(*args, cfg, mesh, top_k={top_k})
    sites = None
    res[name + "/top_s"], res[name + "/top_i"] = full(top_s), full(top_i)
if rank == 0:
    np.savez(os.path.join(out, "rank0.npz"), **res)
    with open(os.path.join(out, "sites.json"), "w") as f:
        json.dump(site_log, f)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The five archs on four gloo ranks (rank 0's results) beside the JAX
    package's on the same weights and inputs."""
    out = tmp_path_factory.mktemp("four_ranks_graph")
    want = {name: _jax_gnn(name, out) for name in GNN}
    want.update({name: _jax_dcn(name, out) for name in DCN})
    code = textwrap.dedent(_RANK.format(
        gnn=list(GNN), dcn=DCN, b=B, b_q=B_Q, n_cand=N_CAND, top_k=TOP_K))
    # one thread per rank: four ranks beside the other test workers
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(out / "store"), str(out)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(4)]
    for proc in procs:
        log, _ = proc.communicate(timeout=500)
        assert proc.returncode == 0, log[-3000:]
    got = dict(np.load(out / "rank0.npz"))
    with open(out / "sites.json") as f:
        got["sites"] = json.load(f)
    return got, want


def _close(got, want, tol):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    atol = tol * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=tol, atol=atol)


@pytest.mark.parametrize("name", ARCHS)
def test_sharded_forward_and_loss_match_jax(four_ranks, name):
    got, want = four_ranks
    for key in ("logits", "loss"):
        _close(got[f"{name}/{key}"], want[name][key], TOL)


@pytest.mark.parametrize("name", ARCHS)
def test_sharded_training_step_matches_jax(four_ranks, name):
    """The loss, AdamW's moments (1e-4, as gradients) and the new params
    (1e-5) of one step of the workload's training step."""
    got, want = four_ranks
    _close(got[f"{name}/step_loss"], want[name]["step_loss"], TOL)
    for part, tol in (("mu", TOL), ("nu", TOL), ("new", STEP_TOL)):
        leaves = want[name][part]
        paths = {k: "/".join(f"[{p!r}]" for p in k.split("/"))
                 for k in leaves}
        assert sorted(k for k in got if k.startswith(f"{name}/{part}/")) \
            == sorted(f"{name}/{part}/{p}" for p in paths.values())
        for k, w in leaves.items():
            _close(got[f"{name}/{part}/{paths[k]}"], w, tol)
    # every table learns: a lookup that lost its rank's rows would not
    if name in DCN:
        for k in want[name]["mu"]:
            if k.startswith("tables/"):
                assert np.abs(got[f"{name}/mu/{paths[k]}"]).max() > 0, k


@pytest.mark.parametrize("name", list(DCN))
def test_sharded_dcn_serve_and_retrieval_match_jax(four_ranks, name):
    got, want = four_ranks
    _close(got[f"{name}/serve"], want[name]["logits"], TOL)
    _close(got[f"{name}/top_s"], want[name]["top_s"], TOL)
    np.testing.assert_array_equal(got[f"{name}/top_i"],
                                  np.asarray(want[name]["top_i"]))


@pytest.mark.parametrize("name", ARCHS)
def test_every_constrain_site_matches_jax(four_ranks, name):
    """The port's ``constrain`` calls are the JAX package's, call for call:
    the same logical spec on the same shape (JAX scans one layer's calls,
    the port runs every layer's), each leaving the placements JAX's
    ``resolve`` gives that spec on (2, 2)."""
    got, want = four_ranks
    for part, log in want[name]["sites"].items():
        calls = got["sites"][f"{name}/{part}"]
        if name in GNN:
            n_layers = jax_get_arch(name).smoke_config.n_layers
            # the state's arrays: the node state, and gatedgcn's edges
            k = 2 if name == "gatedgcn" else 1
            head = 3 if name == "equiformer-v2" else 1 + k
            expect = log[:head] + log[head:] * n_layers
        else:
            expect = log
        assert len(calls) == len(expect) > 0, part
        assert [c[:2] for c in calls] == [e[:2] for e in expect], part
        assert [c[2] for c in calls] == [e[2] for e in expect], part
