"""Sharding on DTensor in the port (the rest of slice 9) against the JAX
package: the logical-axis resolver, the workloads' shardings and batch
shards, and the LM archs run on a real four-rank mesh.

- ``resolve`` for every ParamSpec of every arch's CONFIG and SMOKE (LM,
  GNN, equiformer, DCN-v2) and every LM ``cache_specs`` at each
  ``LMShape``, on meshes (16, 16), (2, 16, 16), (2, 2, 2), (2, 2) and (1,):
  the JAX resolver reads only ``mesh.shape``, so it gets a stand-in with
  that mapping; the port's side runs on a fake process group of each
  mesh's ranks in one subprocess.
- ``_batch_shards`` and ``choose_microbatches`` of every LM cell on the
  production meshes, ``graph_shardings`` and DCN-v2's batch specs, each
  equal to the JAX package's (its ``named_sharding`` stands in by its
  ``resolve`` on the stand-in mesh).
- granite-8b (dense), gemma3-1b (sliding window) and moonshot (MoE) at
  SMOKE on a real 2-D gloo (2, 2) mesh of four CPU ranks, started once per
  module as subprocesses, on ``test_torch_lm_train.py``'s step input
  ([4, 32] tokens, seed 5): ``forward`` logits, ``loss_fn``, one
  ``lm_train_workload`` step in 2 microbatches (loss, moments and new
  params) and
  12 ``serve_step`` logits over a cache sharded by ``cache_specs``, each
  against the JAX package's unsharded result on the same weights; the
  ``constrain`` calls of ``forward`` and ``serve_step``, spec, shape and
  the placements they leave, against the JAX package's calls; and the MoE
  block with its token groups sharded, values and gradients, against the
  same block unsharded.  Tolerances:
  ``test_torch_lm.py``'s 1e-4 for the model outputs and
  ``test_torch_lm_train.py``'s 1e-5 for the parameters after a step.
"""

import functools
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

from repro.configs import common as jax_common
from repro.configs import dcn_v2 as jax_dcn
from repro.configs import get_arch as jax_get_arch
from repro.configs import gnn_common as jax_gnn_common
from repro.models import sharding as jax_shd
from repro.models import transformer as jax_transformer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = [(16, 16), (2, 16, 16), (2, 2, 2), (2, 2), (1,)]
AXES = ("pod", "data", "model")
LM = ["granite-8b", "gemma3-1b", "qwen2-72b", "moonshot-v1-16b-a3b",
      "arctic-480b"]
OTHER = ["equiformer-v2", "gatedgcn", "gin-tu", "gat-cora", "dcn-v2"]
RUN = ["granite-8b", "gemma3-1b", "moonshot-v1-16b-a3b"]
TOL, STEP_TOL = 1e-4, 1e-5
B, S, MAX_LEN, STEPS = 4, 32, 16, 12


def _axes(shape):
    return AXES[-len(shape):] if len(shape) > 1 else ("data",)


def _key(shape):
    return "x".join(map(str, shape))


def _standin(shape):
    return types.SimpleNamespace(shape=dict(zip(_axes(shape), shape)))


def _spec_list(p):
    return [list(e) if isinstance(e, tuple) else e for e in p]


# -- the port's side: one subprocess, one fake world per mesh ---------------

_RESOLVE = """
import json, sys
import torch.distributed as dist
from repro_torch.configs import common, dcn_v2, get_arch, gnn_common
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import equiformer, gnn, params as prm, recsys, \\
    sharding as shd, transformer

MESHES, LM, OTHER = {meshes!r}, {lm!r}, {other!r}
AXES = ("pod", "data", "model")


def specs_of(arch, cfg):
    if arch.family == "lm":
        return transformer.param_specs(cfg)
    if arch.family == "recsys":
        return recsys.dcn_param_specs(cfg)
    if arch.name == "equiformer-v2":
        return equiformer.equiformer_param_specs(cfg)
    return gnn.gnn_param_specs(cfg)


def flat(tree, path=""):
    if prm.is_spec(tree):
        return [(path, tree)]
    return [x for k in sorted(tree)
            for x in flat(tree[k], f"{{path}}/{{k}}" if path else k)]


def entry(e):
    return list(e) if isinstance(e, tuple) else e


out = {{}}
for shape in MESHES:
    axes = AXES[-len(shape):] if len(shape) > 1 else ("data",)
    n = 1
    for s in shape:
        n *= s
    mesh_lib.fake_world(n)
    mesh = mesh_lib.make_test_mesh(shape, axes)
    key = "x".join(map(str, shape))
    res = out[key] = {{"params": {{}}, "cache": {{}}, "graph": {{}},
                      "dcn": {{}}, "batch": {{}}}}
    for name in LM + OTHER:
        arch = get_arch(name)
        for which, cfg in (("config", arch.config),
                           ("smoke", arch.smoke_config)):
            for path, s in flat(specs_of(arch, cfg)):
                res["params"][f"{{name}}/{{which}}/{{path}}"] = [
                    entry(e) for e in shd.resolve(s.logical, s.shape, mesh)]
    for name in LM:
        cfg = get_arch(name).config
        for sh in common.LM_SHAPES:
            for path, s in flat(transformer.cache_specs(
                    cfg, sh.global_batch, sh.seq_len)):
                res["cache"][f"{{name}}/{{sh.name}}/{{path}}"] = [
                    entry(e) for e in shd.resolve(s.logical, s.shape, mesh)]
            res["batch"][f"{{name}}/{{sh.name}}"] = [
                common._batch_shards(mesh, sh.global_batch),
                common.choose_microbatches(cfg, sh, mesh)]
    for sh in gnn_common.GNN_SHAPES:
        for pos in (False, True):
            sds = gnn_common.graph_input_specs(sh, with_positions=pos)
            for k, v in gnn_common.graph_shardings(mesh, sds).items():
                res["graph"][f"{{sh.name}}/{{pos}}/{{k}}"] = [
                    entry(e) for e in v.spec]
    for which in ("config", "smoke"):
        cfg = getattr(get_arch("dcn-v2"), dict(config="config",
                                                smoke="smoke_config")[which])
        for sh in dcn_v2.RECSYS_SHAPES:
            for labels in (False, True):
                _, shards = dcn_v2._batch_specs(cfg, sh.batch, mesh, labels)
                for k, v in shards.items():
                    res["dcn"][f"{{which}}/{{sh.name}}/{{labels}}/{{k}}"] = [
                        entry(e) for e in v.spec]
    dist.destroy_process_group()
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def port_side(tmp_path_factory):
    path = tmp_path_factory.mktemp("resolve") / "port.json"
    code = _RESOLVE.format(meshes=MESHES, lm=LM, other=OTHER)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code, str(path)], env=env,
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(path) as f:
        return json.load(f)


def _jax_specs(arch, cfg):
    from repro.models import equiformer, gnn, recsys

    if arch.family == "lm":
        return jax_transformer.param_specs(cfg)
    if arch.family == "recsys":
        return recsys.dcn_param_specs(cfg)
    if arch.name == "equiformer-v2":
        return equiformer.equiformer_param_specs(cfg)
    return gnn.gnn_param_specs(cfg)


def _flat_specs(tree):
    from repro.models.params import is_spec

    return [("/".join(k.key for k in p), s) for p, s in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_spec)[0]]


@pytest.mark.parametrize("mesh", MESHES, ids=_key)
def test_resolve_param_specs_match_jax(port_side, mesh):
    got = port_side[_key(mesh)]["params"]
    standin = _standin(mesh)
    want = {}
    for name in LM + OTHER:
        arch = jax_get_arch(name)
        for which in ("config", "smoke"):
            cfg = arch.config if which == "config" else arch.smoke_config
            for path, s in _flat_specs(_jax_specs(arch, cfg)):
                want[f"{name}/{which}/{path}"] = _spec_list(
                    jax_shd.resolve(s.logical, s.shape, standin))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == want[k], k


@pytest.mark.parametrize("mesh", MESHES, ids=_key)
def test_resolve_cache_specs_match_jax(port_side, mesh):
    got = port_side[_key(mesh)]["cache"]
    standin = _standin(mesh)
    n = 0
    for name in LM:
        cfg = jax_get_arch(name).config
        for sh in jax_common.LM_SHAPES:
            for path, s in _flat_specs(jax_transformer.cache_specs(
                    cfg, sh.global_batch, sh.seq_len)):
                assert got[f"{name}/{sh.name}/{path}"] == _spec_list(
                    jax_shd.resolve(s.logical, s.shape, standin)), (
                    name, sh.name, path)
                n += 1
    assert n == len(got) == 40


@pytest.mark.parametrize("mesh", MESHES, ids=_key)
def test_batch_shards_and_microbatches_match_jax(port_side, mesh):
    got = port_side[_key(mesh)]["batch"]
    standin = _standin(mesh)
    for name in LM:
        cfg = jax_get_arch(name).config
        for sh in jax_common.LM_SHAPES:
            assert got[f"{name}/{sh.name}"] == [
                jax_common._batch_shards(standin, sh.global_batch),
                jax_common.choose_microbatches(cfg, sh, standin)], (
                name, sh.name)


@pytest.fixture
def jax_resolving(monkeypatch):
    """The JAX package's ``named_sharding`` answering its resolved spec,
    so its workload helpers run on a stand-in mesh."""
    monkeypatch.setattr(jax_shd, "named_sharding",
                        lambda m, spec, shape: jax_shd.resolve(spec, shape,
                                                               m))


@pytest.mark.parametrize("mesh", MESHES, ids=_key)
def test_graph_and_dcn_shardings_match_jax(port_side, mesh, jax_resolving):
    got = port_side[_key(mesh)]
    standin = _standin(mesh)
    for sh in jax_gnn_common.GNN_SHAPES:
        for pos in (False, True):
            sds = jax_gnn_common.graph_input_specs(sh, with_positions=pos)
            for k, v in jax_gnn_common.graph_shardings(standin, sds).items():
                assert got["graph"][f"{sh.name}/{pos}/{k}"] == \
                    _spec_list(v), (sh.name, k)
    for which in ("config", "smoke"):
        arch = jax_get_arch("dcn-v2")
        cfg = arch.config if which == "config" else arch.smoke_config
        for sh in jax_dcn.RECSYS_SHAPES:
            for labels in (False, True):
                _, shards = jax_dcn._batch_specs(cfg, sh.batch, standin,
                                                 labels)
                for k, v in shards.items():
                    assert got["dcn"][f"{which}/{sh.name}/{labels}/{k}"] \
                        == _spec_list(v), (which, sh.name, k)


def test_placements_follow_the_resolved_spec():
    """Each mesh dimension an axis group uses shards its dimension, major
    axis first; a group against the mesh's order is refused."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.models import sharding as shd

    mesh = types.SimpleNamespace(mesh_dim_names=AXES, shape=(2, 4, 4))
    assert shd.resolve((shd.BATCH, None, shd.MODEL), (8, 3, 12), mesh) == (
        ("pod", "data"), None, "model")
    assert shd.placements((("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert shd.placements((None, "data"), mesh) == (
        Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError, match="order"):
        shd.placements((("model", "data"),), mesh)


# -- the LM archs on a real (2, 2) gloo mesh --------------------------------

_RANK = """
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Shard

rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", store=dist.FileStore(store, 4), rank=rank,
                        world_size=4)
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))

from repro_torch.configs import common, get_arch
from repro_torch.core import convert
from repro_torch.models import params as prm, sharding as shd, transformer
from repro_torch.training import optimizer
from repro_torch.training.tree import flatten_with_paths

sites = None          # the list the current pass records its sites into
plain_constrain = shd.constrain


def entry(e):
    return list(e) if isinstance(e, tuple) else e


def laid_out(y):
    # the mesh axes that shard each dimension of DTensor y
    names = y.device_mesh.mesh_dim_names
    out = []
    for d in range(y.ndim):
        axes = [n for n, q in zip(names, y.placements) if q == Shard(d)]
        out.append(entry(tuple(axes)) if len(axes) > 1 else
                   axes[0] if axes else None)
    return out


def constrain(x, mesh_, *spec):
    y = plain_constrain(x, mesh_, *spec)
    if sites is not None:
        sites.append([sys._getframe(1).f_code.co_name,
                      [entry(e) for e in spec], list(y.shape), laid_out(y)])
    return y


shd.constrain = constrain
site_log = {{}}


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


res = {{}}
for name in {archs!r}:
    data = dict(np.load(os.path.join(out, name + ".npz")))
    tokens = torch.as_tensor(data.pop("__tokens"))
    targets = torch.as_tensor(data.pop("__targets"))
    cfg = get_arch(name).smoke_config
    params = convert.params_from_numpy(nest(data), "cpu")
    specs = transformer.param_specs(cfg)
    p = prm.place_tree(params, prm.tree_shardings(mesh, specs))
    tok_shd = shd.named_sharding(mesh, (shd.BATCH, None), tokens.shape)
    batch = {{"tokens": prm.place_tree(tokens, tok_shd),
              "targets": prm.place_tree(targets, tok_shd)}}
    sites = site_log[name + "/forward"] = []
    logits, aux = transformer.forward(p, batch["tokens"], cfg, mesh)
    sites = None
    res[name + "/logits"] = full(logits)
    res[name + "/aux"] = full(aux)
    res[name + "/loss"] = full(transformer.loss_fn(p, batch, cfg, mesh))

    shape = common.LMShape("tiny", {s}, {b}, "train")
    wl = common.lm_train_workload(cfg, shape, mesh, microbatches=2)
    args = wl.place((params, optimizer.init_state(params),
                     {{"tokens": tokens, "targets": targets}}))
    new_p, new_o, metrics = wl.fn(*args)
    res[name + "/step_loss"] = full(metrics["loss"])
    res[name + "/grad_norm"] = full(metrics["grad_norm"])
    for part, tree in (("new", new_p), ("mu", new_o.mu), ("nu", new_o.nu)):
        for path, x in flatten_with_paths(tree):
            res[name + "/" + part + "/" + path] = full(x)

    cache = prm.place_tree(
        transformer.init_cache(cfg, {b}, {max_len}, device="cpu"),
        prm.tree_shardings(mesh, transformer.cache_specs(
            cfg, {b}, {max_len})))
    seq_sharded = [q for q in cache["k"].placements if q.is_shard(2)]
    res[name + "/cache_seq_shards"] = np.asarray(len(seq_sharded))
    for i in range({steps}):
        step_tok = prm.place_tree(tokens[:, i:i + 1], shd.named_sharding(
            mesh, (shd.BATCH, None), ({b}, 1)))
        if i == 0:
            sites = site_log[name + "/serve"] = []
        lg, cache = transformer.serve_step(p, cache, step_tok, i, cfg, mesh)
        sites = None
        res[name + "/serve%d" % i] = full(lg)
# the MoE block with its token groups sharded over "data" (4 groups of
# 16 tokens), values and gradients, beside the same block unsharded
from repro_torch.models import moe
from repro_torch.training.tree import value_and_grad

g = torch.Generator().manual_seed(3)
d, e, f = 8, 4, 16
x = torch.randn(64, d, generator=g)
ws = {{"w_router": torch.randn(d, e, generator=g),
       "w_gate": torch.randn(e, d, f, generator=g) * 0.3,
       "w_up": torch.randn(e, d, f, generator=g) * 0.3,
       "w_down": torch.randn(e, f, d, generator=g) * 0.3}}
r = torch.randn(64, d, generator=g)
specs = {{"w_router": (shd.FSDP, None),
          "w_gate": (shd.MODEL, shd.FSDP, None),
          "w_up": (shd.MODEL, shd.FSDP, None),
          "w_down": (shd.MODEL, None, shd.FSDP)}}


def moe_loss(w, x_, r_, mesh_):
    out = moe.moe_block(x_, top_k=2, capacity_factor=1.0, mesh=mesh_,
                        group_size=16, **w)
    return (out * r_).sum()


plain = value_and_grad(moe_loss)(ws, x, r, None)
row = shd.named_sharding(mesh, (shd.BATCH, None), x.shape)
placed = {{k: prm.place_tree(v, shd.named_sharding(mesh, specs[k], v.shape))
           for k, v in ws.items()}}
sharded = value_and_grad(moe_loss)(placed, prm.place_tree(x, row),
                                   prm.place_tree(r, row), mesh)
for tag, (val, grads) in (("plain", plain), ("sharded", sharded)):
    res["moe/" + tag + "/loss"] = full(val)
    for k, v in grads.items():
        res["moe/" + tag + "/" + k] = full(v)
if rank == 0:
    np.savez(os.path.join(out, "rank0.npz"), **res)
    with open(os.path.join(out, "sites.json"), "w") as f:
        json.dump(site_log, f)
dist.destroy_process_group()
"""


def _jax_sites(jcfg, jp, tokens):
    """The JAX package's ``constrain`` calls in ``forward`` and in one
    ``serve_step`` on the (2, 2) mesh (a stand-in with its axis sizes:
    the calls only resolve their spec), each ``[spec, shape, resolved]``;
    a scanned layer's calls appear once."""
    standin = _standin((2, 2))
    log = []

    def record(x, mesh, *spec):
        log.append([_spec_list(spec), list(x.shape),
                    _spec_list(jax_shd.resolve(spec, x.shape, mesh))])
        return x

    plain, jax_shd.constrain = jax_shd.constrain, record
    try:
        jax.eval_shape(lambda p_, t_: jax_transformer.forward(
            p_, t_, jcfg, standin), jp, tokens)
        forward, log = log, []
        jax.eval_shape(lambda p_, c_, t_: jax_transformer.serve_step(
            p_, c_, t_, 0, jcfg, standin), jp,
            jax_transformer.init_cache(jcfg, B, MAX_LEN), tokens[:, :1])
    finally:
        jax_shd.constrain = plain
    return {"forward": forward, "serve": log}


def _jax_model(name):
    jcfg = jax_get_arch(name).smoke_config
    jp = jax.jit(functools.partial(jax_transformer.init_params, cfg=jcfg))(
        jax.random.PRNGKey(0))
    return jcfg, jp


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The three archs on four gloo ranks (rank 0's results) beside the
    JAX package's on the same weights and tokens."""
    out = tmp_path_factory.mktemp("four_ranks")
    want = {}
    for name in RUN:
        jcfg, jp = _jax_model(name)
        # test_torch_lm_train.py's microbatched step's input
        tokens = np.random.default_rng(5).integers(
            0, jcfg.vocab, (B, S)).astype(np.int32)
        targets = np.roll(tokens, -1, 1)
        flat = {"/".join(str(k.key) for k in path): np.asarray(x)
                for path, x in jax.tree_util.tree_flatten_with_path(jp)[0]}
        np.savez(out / f"{name}.npz", __tokens=tokens, __targets=targets,
                 **flat)
        jbatch = {"tokens": jnp.asarray(tokens),
                  "targets": jnp.asarray(targets)}
        (logits, aux), loss = jax.jit(lambda p_, b_, c=jcfg: (
            jax_transformer.forward(p_, b_["tokens"], c),
            jax_transformer.loss_fn(p_, b_, c)))(jp, jbatch)
        want[name] = {"logits": logits, "aux": aux, "loss": loss,
                      "sites": _jax_sites(jcfg, jp, jbatch["tokens"])}
        mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                                 ("data", "model"))
        jw = jax_common.lm_train_workload(
            jcfg, jax_common.LMShape("tiny", S, B, "train"), mesh,
            microbatches=2)
        opt = jax.tree.map(jnp.zeros_like, jp)
        from repro.training import optimizer as jax_opt

        state = jax_opt.AdamWState(step=jnp.zeros((), jnp.int32), mu=opt,
                                   nu=opt)
        new_p, new_o, metrics = jax.jit(jw.fn)(jp, state, jbatch)
        want[name]["step_loss"] = metrics["loss"]
        want[name]["grad_norm"] = metrics["grad_norm"]
        for part, tree in (("new", new_p), ("mu", new_o.mu),
                           ("nu", new_o.nu)):
            want[name][part] = {
                "/".join(str(k.key) for k in path): x
                for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}
        step = jax.jit(lambda p_, c_, t_, i_, c=jcfg:
                       jax_transformer.serve_step(p_, c_, t_, i_, c, None))
        cache = jax_transformer.init_cache(jcfg, B, MAX_LEN)
        for i in range(STEPS):
            lg, cache = step(jp, cache, jnp.asarray(tokens[:, i:i + 1]),
                             jnp.asarray(i, jnp.int32))
            want[name][f"serve{i}"] = lg
    code = textwrap.dedent(_RANK.format(archs=RUN, b=B, s=S,
                                        max_len=MAX_LEN, steps=STEPS))
    # one thread per rank: four ranks beside the other test workers
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(out / "store"), str(out)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(4)]
    for proc in procs:
        log, _ = proc.communicate(timeout=400)
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


@pytest.mark.parametrize("name", RUN)
def test_sharded_forward_and_loss_match_jax(four_ranks, name):
    got, want = four_ranks
    for key in ("logits", "aux", "loss"):
        _close(got[f"{name}/{key}"], want[name][key], TOL)


@pytest.mark.parametrize("name", RUN)
def test_sharded_training_step_matches_jax(four_ranks, name):
    """The loss and gradient norm, AdamW's moments (1e-4, as gradients)
    and the new params (1e-5) of the microbatched step, on the input
    ``test_torch_lm_train.py``'s step test holds the unsharded port to."""
    got, want = four_ranks
    _close(got[f"{name}/step_loss"], want[name]["step_loss"], TOL)
    _close(got[f"{name}/grad_norm"], want[name]["grad_norm"], TOL)
    for part, tol in (("mu", TOL), ("nu", TOL), ("new", STEP_TOL)):
        leaves = want[name][part]
        paths = {k: "/".join(f"[{p!r}]" for p in k.split("/"))
                 for k in leaves}
        assert sorted(k for k in got if k.startswith(f"{name}/{part}/")) \
            == sorted(f"{name}/{part}/{p}" for p in paths.values())
        for k, w in leaves.items():
            _close(got[f"{name}/{part}/{paths[k]}"], w, tol)


@pytest.mark.parametrize("name", RUN)
def test_sharded_decode_matches_jax(four_ranks, name):
    got, want = four_ranks
    # the cache's sequence is sharded, so the decode combines the shards
    assert int(got[f"{name}/cache_seq_shards"]) == 1
    for i in range(STEPS):
        _close(got[f"{name}/serve{i}"], want[name][f"serve{i}"], TOL)


def test_sharded_moe_groups_match_the_unsharded_block(four_ranks):
    """The MoE block with 4 token groups over the 2-way "data" axis (the
    groups ride the batch axes, each rank dispatches its own, the experts
    ride "model"): value and every weight's gradient against the same
    block unsharded (held against the JAX package by test_torch_lm.py)."""
    got, _ = four_ranks
    for k in ("loss", "w_router", "w_gate", "w_up", "w_down"):
        want = got[f"moe/plain/{k}"]
        assert np.abs(want).max() > 0, k
        _close(got[f"moe/sharded/{k}"], want, TOL)


@pytest.mark.parametrize("name", RUN)
def test_every_constrain_site_takes_the_resolved_placements(four_ranks,
                                                           name):
    """The port's ``constrain`` calls in ``forward`` and a ``serve_step``
    on the (2, 2) mesh are the JAX package's, call for call: the same
    logical spec on the same shape (JAX scans one layer's calls, the port
    runs every layer's), and the placements each call leaves are the ones
    JAX's ``resolve`` gives that spec.  The port's one site of its own,
    the MoE's token groups (``grouped``: tokens, experts and weights split
    into ``[G, S, .]`` groups, which JAX's vmap leaves to propagation),
    takes JAX's resolution of its spec too."""
    got, want = four_ranks
    n_layers = jax_get_arch(name).smoke_config.n_layers
    moe = jax_get_arch(name).smoke_config.moe
    for part in ("forward", "serve"):
        calls = got["sites"][f"{name}/{part}"]
        ours = [c[1:] for c in calls if c[0] == "grouped"]
        calls = [c[1:] for c in calls if c[0] != "grouped"]
        log = want[name]["sites"][part]
        head, body, tail = ((log[:1], log[1:-1], log[-1:])
                            if part == "forward" else ([], log, []))
        expect = head + body * n_layers + tail
        assert [c[:2] for c in calls] == [e[:2] for e in expect], part
        assert [c[2] for c in calls] == [e[2] for e in expect], part
        assert len(ours) == (3 * n_layers if moe else 0)
        for spec, shape, laid in ours:
            assert laid == _spec_list(jax_shd.resolve(
                tuple(tuple(e) if isinstance(e, list) else e for e in spec),
                shape, _standin((2, 2))))
    assert len(got["sites"][f"{name}/forward"]) >= 2 + 3 * n_layers
