"""The port's training half of slice 9 against the JAX package: losses
and gradients of the GNN and DCN-v2 models, AdamW, checkpoints, the
training loop, the elastic mesh policy and the motif-features example.

Parameters are made by the JAX package's ``tree_init`` and carried across
with ``convert.params_from_numpy``; graphs, batches and gradients come
from the same numpy seeds in both.  The JAX package differentiates with
``use_pallas=False`` (its XLA segment sums and bags); the port's
gradients run through the autograd Functions of the segment scatter-sum
and the grouped embedding bag, whose plain versions run on the CPU.
Gradient tolerance: rtol 1e-4 and an atol of 1e-4 times the leaf's
largest |grad| — float32 sums taken in other orders by XLA and PyTorch,
through several layers.  AdamW: rtol 1e-6 over 3 steps, with an atol of
1e-6 times the leaf's largest magnitude (see the test).  Checkpoints and
a resumed loop: bitwise.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs.gnn_common import GNNShape as JaxGNNShape
from repro.configs.gnn_common import _specialize as jax_specialize
from repro.data import graph_data as jax_graph_data
from repro.models import gnn as jax_gnn
from repro.models import params as jax_params
from repro.models import recsys as jax_recsys
from repro.training import checkpoint as jax_checkpoint
from repro.training import elastic as jax_elastic
from repro.training import optimizer as jax_optimizer
from repro_torch.core import convert
from repro_torch.data import graph_data
from repro_torch.kernels.embedding_bag import ops as bag_ops
from repro_torch.kernels.embedding_bag import ref as bag_ref
from repro_torch.kernels.segment_spmm import ops as spmm_ops
from repro_torch.kernels.segment_spmm import ref as spmm_ref
from repro_torch.models import gnn, recsys
from repro_torch.training import (checkpoint, elastic, optimizer,
                                  train_loop)
from repro_torch.training.tree import (flatten_with_paths, leaves,
                                       value_and_grad)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GNN_CASES = ["gin-tu", "gat-cora", "gatedgcn", "gcn"]
N, E, F_IN, PAD_N, PAD_E = 48, 160, 12, 56, 200


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _hold_grads(got, want, nan_leaves=()):
    """Every leaf of the port's gradient tree within rtol 1e-4 and atol
    1e-4 x max|grad| of the JAX one; a path in ``nan_leaves`` is one the
    JAX package makes NaN and the port finite (see the gatedgcn case)."""
    got = dict(flatten_with_paths(got))
    want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    want = {"/".join(str(k) for k in p): v for p, v in want.items()}
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g, w = _np(got[path]), np.asarray(w)
        assert g.shape == w.shape, path
        if path in nan_leaves:
            assert np.isnan(w).any() and np.isfinite(g).all(), path
            continue
        atol = 1e-4 * max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=atol,
                                   err_msg=path)


def _gnn_case(name, readout, pad=True, seed=11):
    n_graphs, n_classes = (4, 3) if readout == "graph" else (0, 5)
    base = jax_get_arch("gin-tu" if name == "gcn" else name).smoke_config
    if name == "gcn":      # no arch uses gcn: the gin smoke widths
        base = dataclasses.replace(base, name="gcn-smoke", kind="gcn")
    jcfg = dataclasses.replace(jax_specialize(base, JaxGNNShape(
        "tiny", N, E, F_IN, n_classes, n_graphs=n_graphs)),
        use_pallas=False)
    kw = dict(n_nodes=N, n_edges=E, d_feat=F_IN, n_classes=n_classes,
              n_graphs=n_graphs, seed=seed,
              pad_nodes=PAD_N if pad else 0, pad_edges=PAD_E)
    jp = jax_params.tree_init(jax.random.PRNGKey(0),
                              jax_gnn.gnn_param_specs(jcfg))
    return (jcfg, jax_graph_data.random_graph_batch(**kw), jp,
            convert.gnn_config_from(jcfg),
            graph_data.random_graph_batch(**kw, device="cpu"),
            convert.params_from_numpy(jp, "cpu"))


def _count_calls(monkeypatch, module, names):
    counts = dict.fromkeys(names, 0)
    for name in names:
        orig = getattr(module, name)

        def tap(*args, _name=name, _orig=orig, **kwargs):
            counts[_name] += 1
            return _orig(*args, **kwargs)

        monkeypatch.setattr(module, name, tap)
    return counts


@pytest.mark.parametrize("readout", ["node", "graph"])
@pytest.mark.parametrize("name", GNN_CASES)
def test_gnn_loss_and_grads_match_jax(name, readout, monkeypatch):
    """Loss and every gradient leaf of ``gnn.loss_fn`` equal
    ``jax.value_and_grad``'s; the gradients of the aggregations came
    through B4's autograd Function: B4 on the transposed plan for the
    node rows (gin, gcn: one per layer), the masked gather for per-edge
    messages (gat: one per layer, gatedgcn: two).

    gatedgcn on a padded graph: the pad nodes' rows are all zero, so the
    layer norm divides a zero row by its zero std.  JAX's ``jnp.std``
    gradient there is NaN, which reaches all of ``wu``; PyTorch defines
    it as 0.  The port's ``wu`` gradient is finite; every other leaf
    agrees, and the unpadded case below agrees on ``wu`` too."""
    jcfg, jg, jp, cfg, g, p = _gnn_case(name, readout)
    want_loss, want = jax.value_and_grad(jax_gnn.loss_fn)(jp, jg, jcfg)
    calls = _count_calls(monkeypatch, spmm_ops, ("edge_grad", "row_grad"))
    loss, grads = value_and_grad(gnn.loss_fn)(p, g, cfg)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    nan = ("['layers']/['wu']",) if name == "gatedgcn" else ()
    _hold_grads(grads, want, nan)
    layers = cfg.n_layers
    expect = {"gin-tu": (0, layers), "gcn": (0, layers),
              "gat-cora": (layers, 0), "gatedgcn": (2 * layers, 0)}[name]
    assert (calls["edge_grad"], calls["row_grad"]) == expect


def test_gatedgcn_grads_on_unpadded_graph_match_jax():
    jcfg, jg, jp, cfg, g, p = _gnn_case("gatedgcn", "node", pad=False)
    want_loss, want = jax.value_and_grad(jax_gnn.loss_fn)(jp, jg, jcfg)
    loss, grads = value_and_grad(gnn.loss_fn)(p, g, cfg)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    _hold_grads(grads, want)


def test_gnn_regression_loss_matches_jax():
    """``n_classes == 1``: the mean squared error of a graph readout."""
    jcfg, jg, jp, cfg, g, p = _gnn_case("gin-tu", "graph")
    jcfg = dataclasses.replace(jcfg, n_classes=1)
    cfg = convert.gnn_config_from(jcfg)
    kw = dict(n_nodes=N, n_edges=E, d_feat=F_IN, n_classes=1, n_graphs=4,
              seed=5, pad_nodes=PAD_N, pad_edges=PAD_E)
    jg = jax_graph_data.random_graph_batch(**kw)
    g = graph_data.random_graph_batch(**kw, device="cpu")
    jp = jax_params.tree_init(jax.random.PRNGKey(1),
                              jax_gnn.gnn_param_specs(jcfg))
    p = convert.params_from_numpy(jp, "cpu")
    want_loss, want = jax.value_and_grad(jax_gnn.loss_fn)(jp, jg, jcfg)
    loss, grads = value_and_grad(gnn.loss_fn)(p, g, cfg)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    _hold_grads(grads, want)


def _dcn_batch(cfg, b, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "dense": rng.standard_normal((b, cfg.n_dense)).astype(np.float32),
        # negative ids down to -V/4 wrap, as jnp.take does
        "sparse_ids": np.stack([rng.integers(-(v // 4), v, (b, cfg.bag_size))
                                for v in cfg.vocab_sizes], 1).astype(
                                    np.int32),
        "sparse_weights": rng.uniform(0.0, 1.0, (
            b, cfg.n_sparse, cfg.bag_size)).astype(np.float32),
        "labels": rng.integers(0, 2, b).astype(np.float32),
    }


def test_dcn_loss_and_grads_match_jax(monkeypatch):
    """Every table, the cross and MLP weights get ``jax.value_and_grad``'s
    gradient; the tables' through B5's autograd Function (one grouped
    backward per step); the item table and query projection, which the
    loss does not read, get zeros, as in JAX."""
    jcfg = dataclasses.replace(jax_get_arch("dcn-v2").smoke_config,
                               use_pallas=False)
    cfg = convert.dcn_config_from(jcfg)
    jp = jax_params.tree_init(jax.random.PRNGKey(0),
                              jax_recsys.dcn_param_specs(jcfg))
    batch = _dcn_batch(cfg, 64)
    want_loss, want = jax.value_and_grad(jax_recsys.loss_fn)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    calls = _count_calls(monkeypatch, bag_ops, ("fields_backward",))
    loss, grads = value_and_grad(recsys.loss_fn)(
        convert.params_from_numpy(jp, "cpu"),
        {k: torch.as_tensor(v) for k, v in batch.items()}, cfg)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    _hold_grads(grads, want)
    assert calls["fields_backward"] == 1
    assert float(grads["item_table"].abs().max()) == 0.0
    assert all(float(t.abs().max()) > 0 for t in grads["tables"].values())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embedding_bag_fields_backward_is_the_transpose(dtype):
    """The plain backward (one ``index_add_`` per field) equals autograd
    through the plain forward, with duplicate ids, wrapped negative ids
    and ids outside the table (a NaN bag: no gradient to the table);
    ``grad_dense`` is the dense columns of the output gradient."""
    rng = np.random.default_rng(4)
    vocabs, d, b, k, n_dense = (7, 30, 3), 8, 20, 5, 3
    tables = [torch.as_tensor(rng.standard_normal((v, d)).astype(
        np.float32)).to(dtype).requires_grad_() for v in vocabs]
    ids = np.stack([rng.integers(-v, v + 2, (b, k)) for v in vocabs], 1)
    ids[0, 0, :] = 1                                   # duplicates
    ids = torch.as_tensor(ids.astype(np.int32))
    w = torch.as_tensor(rng.uniform(0, 1, (b, len(vocabs), k)).astype(
        np.float32))
    dense = torch.randn(b, n_dense, generator=torch.Generator().manual_seed(
        0)).requires_grad_()
    grad_x0 = torch.randn(b, n_dense + len(vocabs) * d,
                          generator=torch.Generator().manual_seed(1))
    want_x0 = bag_ref.embedding_bag_fields(tables, ids, w, dense)
    want = torch.autograd.grad(want_x0, [dense, *tables], grad_x0)
    x0 = bag_ops.embedding_bag_fields(tables, ids, w, dense)
    got = torch.autograd.grad(x0, [dense, *tables], grad_x0)
    torch.testing.assert_close(x0, want_x0, equal_nan=True)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 \
        else dict(rtol=2e-2, atol=5e-2)
    for a, bb in zip(got, want):
        assert a.dtype == bb.dtype
        torch.testing.assert_close(a.float(), bb.float(), **tol)
    with pytest.raises(ValueError, match="no gradient for weights"):
        bag_ops.embedding_bag_fields(tables, ids, w.requires_grad_(), dense)


@pytest.mark.parametrize("masked", [False, True])
def test_segment_sum_backward_matches_autograd_of_plain(masked):
    """B4's two backwards on the CPU: per-edge values (a masked gather)
    and node rows read through ``plan.compose(src)`` (B4 on the
    transposed plan) equal autograd through ``ref.scatter_sum`` on the
    materialised messages, with dropped, masked and out-of-range rows."""
    rng = np.random.default_rng(2)
    n, e, d = 9, 40, 6
    src = torch.as_tensor(rng.integers(0, n, e).astype(np.int32))
    dst = torch.as_tensor(rng.integers(-1, n + 2, e).astype(np.int32))
    mask = torch.as_tensor(rng.random(e) < 0.7) if masked else None
    h = torch.randn(n, d, generator=torch.Generator().manual_seed(3))
    vals = torch.randn(e, d, generator=torch.Generator().manual_seed(4))
    grad = torch.randn(n, d, generator=torch.Generator().manual_seed(5))
    plan = spmm_ops.plan(dst, n, mask)
    for x, rows in ((vals, None), (h, plan.compose(src))):
        x = x.clone().requires_grad_()
        msgs = x if rows is None else x[src.long()]
        want_out = spmm_ref.scatter_sum(msgs, dst, n, mask)
        (want,) = torch.autograd.grad(want_out, x, grad)
        out = spmm_ops.segment_sum(x, plan, rows)
        (got,) = torch.autograd.grad(out, x, grad)
        torch.testing.assert_close(out, want_out, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def _tree_pairs(seed=0):
    """A GNN parameter tree (JAX's, and the port's copy) and three steps
    of gradients made with numpy."""
    jcfg = jax_get_arch("gin-tu").smoke_config
    jp = jax_params.tree_init(jax.random.PRNGKey(seed),
                              jax_gnn.gnn_param_specs(jcfg))
    rng = np.random.default_rng(seed)
    grads = [jax.tree.map(lambda x: (rng.standard_normal(x.shape) * s)
                          .astype(np.float32), jp) for s in (0.05, 3.0, 0.5)]
    return jp, convert.params_from_numpy(jp, "cpu"), grads


@pytest.mark.parametrize("clip,wd", [(1.0, 0.1), (0.0, 0.0)])
def test_apply_updates_matches_jax(clip, wd):
    jp, p, grads = _tree_pairs()
    jcfg = jax_optimizer.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=5,
                                     grad_clip=clip, weight_decay=wd)
    cfg = optimizer.AdamWConfig(**dataclasses.asdict(jcfg))
    jstate, state = jax_optimizer.init_state(jp), optimizer.init_state(p)
    for g in grads:
        jp, jstate, jm = jax_optimizer.apply_updates(jcfg, jp, g, jstate)
        p, state, m = optimizer.apply_updates(
            cfg, p, convert.params_from_numpy(g, "cpu"), state)
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=1e-6)
    assert int(state.step) == int(jstate.step) == 3
    # the global norm is summed in another order (a few ulp apart), and
    # elements near zero (moments that change sign, biases that start at
    # 0) carry that as a large relative error: atol is 1e-6 x the leaf's
    # largest magnitude
    for a, b in zip(leaves((p, state.mu, state.nu)),
                    jax.tree.leaves((jp, jstate.mu, jstate.nu))):
        b = np.asarray(b)
        np.testing.assert_allclose(_np(a), b, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(b).max()))


def test_schedule_matches_jax():
    for kw in ({}, dict(warmup_steps=0, total_steps=10),
               dict(warmup_steps=7, total_steps=50, min_lr_ratio=0.0)):
        jcfg = jax_optimizer.AdamWConfig(**kw)
        cfg = optimizer.AdamWConfig(**kw)
        for step in (0, 1, 3, 7, 50, 99, 100, 101, 5_000, 10_000, 20_000):
            np.testing.assert_allclose(
                float(optimizer.schedule(cfg, torch.tensor(step))),
                float(jax_optimizer.schedule(jcfg, jnp.asarray(step))),
                rtol=1e-6)


def test_choose_mesh_shape_matches_jax():
    for n in range(1, 65):
        for kw in ({}, dict(model_parallel=4, pod_size=16),
                   dict(model_parallel=8, pod_size=8)):
            assert elastic.choose_mesh_shape(n, **kw) == \
                jax_elastic.choose_mesh_shape(n, **kw), (n, kw)
    assert elastic.choose_mesh_shape(512, model_parallel=16,
                                     pod_size=256) == (
        (2, 16, 16), ("pod", "data", "model"))


def _state_trees():
    jp, p, _ = _tree_pairs(seed=3)
    jtree = {"params": jp, "opt": jax_optimizer.init_state(jp)}
    tree = {"params": p, "opt": optimizer.init_state(p)}
    return jtree, tree


def test_checkpoint_paths_equal_jax_and_cross_restore(tmp_path):
    """A checkpoint written by either package restores in the other; the
    manifests name the same paths (``['opt']/.mu/['layers']/...``)."""
    jtree, tree = _state_trees()
    jtree = {**jtree, "opt": jtree["opt"]._replace(step=jnp.asarray(
        4, jnp.int32))}
    tree = {**tree, "opt": tree["opt"]._replace(step=torch.tensor(
        4, dtype=torch.int32))}
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_checkpoint.save(jdir, 4, jtree)
    checkpoint.save(pdir, 4, tree)
    with open(os.path.join(jdir, "step_000000004", "MANIFEST.json")) as f:
        jman = json.load(f)
    with open(os.path.join(pdir, "step_000000004", "MANIFEST.json")) as f:
        pman = json.load(f)
    assert pman == jman
    assert "['opt']/.mu/['layers']/['eps']" in pman["paths"]
    got, step = checkpoint.restore(jdir, tree)
    assert step == 4
    for a, b in zip(leaves(got), jax.tree.leaves(jtree)):
        assert torch.is_tensor(a)
        np.testing.assert_array_equal(_np(a), np.asarray(b))
        assert _np(a).dtype == np.asarray(b).dtype
    jgot, step = jax_checkpoint.restore(pdir, jtree)
    assert step == 4
    for a, b in zip(jax.tree.leaves(jgot), leaves(tree)):
        np.testing.assert_array_equal(np.asarray(a), _np(b))


def test_checkpoint_gc_latest_and_partial_save(tmp_path):
    _, tree = _state_trees()
    for s in (1, 2, 3, 4, 5):
        checkpoint.save(str(tmp_path), s, {"params": tree["params"]},
                        keep=2)
    assert checkpoint.latest_step(str(tmp_path)) == 5
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert kept == ["step_000000004", "step_000000005"]
    os.makedirs(tmp_path / "step_000000006.tmp")       # simulated crash
    assert checkpoint.latest_step(str(tmp_path)) == 5
    bf = {"w": torch.randn(3, 2).to(torch.bfloat16)}
    checkpoint.save(str(tmp_path / "bf"), 1, bf)
    back, _ = checkpoint.restore(str(tmp_path / "bf"), bf)
    assert back["w"].dtype == torch.bfloat16
    assert torch.equal(back["w"], bf["w"])
    with pytest.raises(ValueError, match="tree mismatch"):
        checkpoint.restore(str(tmp_path), {"other": tree["params"]})


def _gin_training(tmp_path, name):
    """gin-tu smoke training on a graph from a seed: the step function,
    the starting state and the loop's config for ``tmp_path / name``."""
    _, _, _, cfg, g, p = _gnn_case("gin-tu", "node")
    opt_cfg = optimizer.AdamWConfig(lr=1e-2, warmup_steps=1)
    grad_fn = value_and_grad(gnn.loss_fn)

    def step_fn(params, opt_state, batch):
        loss, grads = grad_fn(params, batch, cfg)
        params, opt_state, metrics = optimizer.apply_updates(
            opt_cfg, params, grads, opt_state)
        metrics["loss"] = loss
        return params, opt_state, metrics

    def batches():
        while True:
            yield g

    def loop(total):
        return train_loop.TrainLoopConfig(
            total_steps=total, ckpt_dir=str(tmp_path / name), ckpt_every=2,
            log_every=1, metrics_path=str(tmp_path / f"{name}.jsonl"))

    return step_fn, p, optimizer.init_state(p), batches, loop


def test_train_loop_resumed_equals_uninterrupted(tmp_path):
    """Five steps in one run, and three steps then a resume to five from
    the checkpoint, give bitwise the same parameters and moments."""
    step_fn, p, o, batches, loop = _gin_training(tmp_path, "whole")
    p1, o1, hist1 = train_loop.run(step_fn=step_fn, params=p, opt_state=o,
                                   batches=batches(), loop_cfg=loop(5))
    assert [h["step"] for h in hist1] == [1, 2, 3, 4, 5]
    assert checkpoint.latest_step(str(tmp_path / "whole")) == 5
    step_fn, p, o, batches, loop = _gin_training(tmp_path, "split")
    train_loop.run(step_fn=step_fn, params=p, opt_state=o,
                   batches=batches(), loop_cfg=loop(3))
    p2, o2, hist2 = train_loop.run(step_fn=step_fn, params=p, opt_state=o,
                                   batches=batches(), loop_cfg=loop(5),
                                   device="cpu")
    assert [h["step"] for h in hist2] == [4, 5]
    assert int(o2.step) == 5
    for a, b in zip(leaves((p1, o1)), leaves((p2, o2))):
        assert torch.equal(a, b)
    lines = (tmp_path / "split.jsonl").read_text().splitlines()
    assert [json.loads(x)["step"] for x in lines] == [1, 2, 3, 4, 5]
    assert hist1[-1]["loss"] == hist2[-1]["loss"]


def test_value_and_grad_zeros_for_unused_leaves():
    p = {"a": torch.ones(3), "b": torch.ones(2), "n": torch.ones(2,
                                                                  dtype=torch.int32)}
    val, grads = value_and_grad(lambda t: (t["a"] * 2).sum())(p)
    assert float(val) == 6.0
    assert torch.equal(grads["a"], torch.full((3,), 2.0))
    assert torch.equal(grads["b"], torch.zeros(2))
    assert grads["n"] is None


def test_motif_features_equal_jax_example():
    """The port's example mines the same counts and builds the same
    features and labels as ``examples/motif_features.py`` (its mining and
    feature code, run here), and trains a few steps on both graphs."""
    from repro_torch.examples import motif_features

    src = open(os.path.join(ROOT, "examples", "motif_features.py")).read()
    ns: dict = {}
    exec(compile(src[:src.index("\ndef batch(")], "motif_features", "exec"),
         ns)
    graph, res, top, feat, labels = motif_features.mine_features("cpu")
    assert res.counts == ns["res"].counts
    assert top == ns["top_codes"]
    np.testing.assert_array_equal(feat, ns["feat"])
    np.testing.assert_array_equal(labels, ns["labels"])
    for with_motifs in (False, True):
        g = motif_features.graph_batch(graph, feat, labels,
                                       with_motifs=with_motifs, device="cpu")
        loss, acc = motif_features.train(g, steps=3)
        assert np.isfinite(loss) and 0.0 <= acc <= 1.0
