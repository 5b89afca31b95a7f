"""The port's model zoo slice against the JAX package: GNN and DCN-v2
inference, parameter trees, configs and the graph and recsys data paths.

Parameters are made by the JAX package's ``tree_init`` and carried across
with ``convert.params_from_numpy``; graphs and batches come from the same
numpy seeds in both.  Forward tolerance: rtol 1e-5 and an atol of 1e-5
times the output's largest magnitude — float32 matmuls and segment sums
are summed in another order by XLA and by PyTorch's CPU kernels, and a
graph readout sums many node rows, so the error scales with the largest
value summed.  The aggregation goes through ``ops.scatter_sum`` and the
bags through ``ops.embedding_bag``, which run their plain versions on the
CPU; the kernels run on the card only (``chip_smoke.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs.gnn_common import GNNShape as JaxGNNShape
from repro.configs.gnn_common import _specialize as jax_specialize
from repro.data import graph_data as jax_graph_data
from repro.data import graph_sampler as jax_sampler
from repro.data import recsys_pipeline as jax_recsys_pipeline
from repro.models import gnn as jax_gnn
from repro.models import params as jax_params
from repro.models import recsys as jax_recsys
from repro_torch import configs
from repro_torch.configs import gnn_common
from repro_torch.core import convert
from repro_torch.data import graph_data, graph_sampler, recsys_pipeline
from repro_torch.kernels.embedding_bag import ops as bag_ops
from repro_torch.models import gnn, params, recsys

GNN_CASES = ["gin-tu", "gat-cora", "gatedgcn", "gcn"]
N, E, F_IN, PAD_N, PAD_E = 48, 160, 12, 56, 200


def _close(got, want, rtol=1e-5):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    atol = 1e-5 * max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _jax_gnn_config(name, n_graphs, n_classes):
    base = jax_get_arch("gin-tu" if name == "gcn" else name).smoke_config
    if name == "gcn":      # no arch uses gcn: the gin smoke widths
        base = dataclasses.replace(base, name="gcn-smoke", kind="gcn")
    shape = JaxGNNShape("tiny", N, E, F_IN, n_classes, n_graphs=n_graphs)
    return jax_specialize(base, shape)


def _graphs(n_graphs, n_classes, seed=11):
    kw = dict(n_nodes=N, n_edges=E, d_feat=F_IN, n_classes=n_classes,
              n_graphs=n_graphs, seed=seed, pad_nodes=PAD_N, pad_edges=PAD_E)
    return (jax_graph_data.random_graph_batch(**kw),
            graph_data.random_graph_batch(**kw, device="cpu"))


@pytest.mark.parametrize("readout", ["node", "graph"])
@pytest.mark.parametrize("name", GNN_CASES)
def test_gnn_forward_matches_jax(name, readout):
    n_graphs, n_classes = (4, 3) if readout == "graph" else (0, 5)
    jcfg = _jax_gnn_config(name, n_graphs, n_classes)
    cfg = convert.gnn_config_from(jcfg)
    jg, g = _graphs(n_graphs, n_classes)
    jp = jax_params.tree_init(jax.random.PRNGKey(0),
                              jax_gnn.gnn_param_specs(jcfg))
    p = convert.params_from_numpy(jp, "cpu")
    got = gnn.forward(p, g, cfg)
    want = jax_gnn.forward(jp, jg, jcfg)
    assert got.shape == ((n_graphs if n_graphs else PAD_N), n_classes)
    _close(got, want)
    # the JAX package's Pallas aggregation (interpret mode) agrees too
    _close(got, jax_gnn.forward(jp, jg, dataclasses.replace(
        jcfg, use_pallas=True)))


@pytest.mark.parametrize("name", GNN_CASES)
def test_gnn_forward_builds_one_plan(name, monkeypatch):
    """A forward sorts its destinations once: one segment plan, reused by
    every aggregation of every layer (one per layer, two for gatedgcn),
    the gin and gcn ones reading ``h[src]`` through the composed rows."""
    from repro_torch.kernels.segment_spmm import ops as spmm_ops

    cfg = convert.gnn_config_from(_jax_gnn_config(name, 0, 5))
    p = params.tree_init(gnn.gnn_param_specs(cfg),
                         generator=torch.Generator().manual_seed(0),
                         device="cpu")
    _, g = _graphs(0, 5)
    calls, plans = [], []
    sum_rows = spmm_ops.segment_sum
    monkeypatch.setattr(
        spmm_ops, "segment_sum", lambda v, plan, rows=None, transposed=None: (
            calls.append((v.shape[0], rows is None)),
            plans.append(plan), sum_rows(v, plan, rows, transposed))[-1])
    spmm_ops.reset_launches()
    gnn.forward(p, g, cfg)
    # no gradient asked for: no transposed plan
    assert spmm_ops.plans == {"segment_plan": 1, "segment_plan_backward": 0}
    assert spmm_ops.launches == {"segment_spmm": 0,     # CPU: plain version
                                 "segment_spmm_backward": 0}
    per_layer = 2 if name == "gatedgcn" else 1
    assert len(calls) == per_layer * cfg.n_layers
    assert all(q is plans[0] for q in plans)
    fused = name in ("gin-tu", "gcn")
    # node rows with the composed row index, or per-edge rows in order
    assert calls == [(PAD_N, False) if fused else (PAD_E, True)] * len(calls)


def test_segment_softmax_and_scatter_mean_match_jax():
    rng = np.random.default_rng(3)
    e, n, h = 90, 12, 3
    scores = rng.standard_normal((e, h)).astype(np.float32)
    seg = rng.integers(0, n - 2, e).astype(np.int32)  # two empty segments
    mask = rng.random(e) < 0.7
    mask[seg == 0] = False                             # one fully masked
    got = gnn.segment_softmax(torch.as_tensor(scores), torch.as_tensor(seg),
                              n, torch.as_tensor(mask))
    want = jax.vmap(lambda s: jax_gnn.segment_softmax(
        s, jnp.asarray(seg), n, jnp.asarray(mask)), in_axes=1,
        out_axes=1)(jnp.asarray(scores))
    _close(got, want)
    got1 = gnn.segment_softmax(torch.as_tensor(scores[:, 0]),
                               torch.as_tensor(seg), n, torch.as_tensor(mask))
    _close(got1, np.asarray(want)[:, 0])
    vals = rng.standard_normal((e, 5)).astype(np.float32)
    _close(gnn.scatter_mean(torch.as_tensor(vals), torch.as_tensor(seg), n,
                            torch.as_tensor(mask)),
           jax_gnn.scatter_mean(jnp.asarray(vals), jnp.asarray(seg), n,
                                jnp.asarray(mask)))


def test_graph_batches_match_jax():
    for n_graphs, n_classes in ((0, 5), (4, 3), (4, 1)):
        jg, g = _graphs(n_graphs, n_classes, seed=n_graphs + n_classes)
        assert sorted(jg) == sorted(g)
        for k in jg:
            assert np.array_equal(g[k].numpy(), np.asarray(jg[k])), k
    g = graph_data.random_graph_batch(n_nodes=10, n_edges=20, d_feat=3,
                                      n_classes=2, with_positions=True,
                                      device="cpu")
    jg = jax_graph_data.random_graph_batch(n_nodes=10, n_edges=20, d_feat=3,
                                           n_classes=2, with_positions=True)
    assert np.array_equal(g["positions"].numpy(), np.asarray(jg["positions"]))


def test_make_csr_and_sample_subgraph_match_jax():
    rng = np.random.default_rng(5)
    n_nodes = 300
    src = rng.integers(0, n_nodes, 4000)
    dst = rng.integers(0, n_nodes, 4000)
    indptr, indices = graph_data.make_csr(n_nodes, src, dst)
    j_indptr, j_indices = jax_graph_data.make_csr(n_nodes, src, dst)
    assert np.array_equal(indptr, j_indptr)
    assert np.array_equal(indices, j_indices)
    seeds = rng.choice(n_nodes, 16, replace=False)
    for pad in ({}, dict(pad_nodes=2048, pad_edges=300)):
        got = graph_sampler.sample_subgraph(
            indptr, indices, seeds, rng=np.random.default_rng(1), **pad)
        want = jax_sampler.sample_subgraph(
            j_indptr, j_indices, seeds, rng=np.random.default_rng(1), **pad)
        assert sorted(got) == sorted(want)
        for k in want:
            assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k


def _dcn_batch(cfg, b, seed=0):
    """The JAX recsys tests' batch: uniform ids per field, unit weights,
    labels from the first dense feature."""
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((b, cfg.n_dense)).astype(np.float32)
    ids = np.stack([rng.integers(0, v, (b, cfg.bag_size))
                    for v in cfg.vocab_sizes], 1).astype(np.int32)
    weights = rng.random((b, cfg.n_sparse, cfg.bag_size)).astype(np.float32)
    labels = (dense[:, 0] > 0).astype(np.float32)
    arrays = dict(dense=dense, sparse_ids=ids, sparse_weights=weights,
                  labels=labels)
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.as_tensor(v) for k, v in arrays.items()})


def _dcn(seed=0):
    jcfg = jax_get_arch("dcn-v2").smoke_config
    cfg = convert.dcn_config_from(jcfg)
    jp = jax_params.tree_init(jax.random.PRNGKey(seed),
                              jax_recsys.dcn_param_specs(jcfg))
    return jcfg, cfg, jp, convert.params_from_numpy(jp, "cpu")


def test_dcn_forward_and_loss_match_jax():
    jcfg, cfg, jp, p = _dcn()
    jb, b = _dcn_batch(cfg, 32)
    got = recsys.forward(p, b, cfg)
    assert got.shape == (32,)
    _close(got, jax_recsys.forward(jp, jb, jcfg))
    _close(recsys.loss_fn(p, b, cfg), jax_recsys.loss_fn(jp, jb, jcfg))
    _close(recsys.interact_features(p, b["dense"], b["sparse_ids"],
                                    b["sparse_weights"], cfg),
           jax_recsys.interact_features(jp, jb["dense"], jb["sparse_ids"],
                                        jb["sparse_weights"], jcfg))


def test_dcn_query_embedding_and_retrieval_match_jax():
    jcfg, cfg, jp, p = _dcn(seed=1)
    jb, b = _dcn_batch(cfg, 4, seed=2)
    _close(recsys.query_embedding(p, b, cfg),
           jax_recsys.query_embedding(jp, jb, jcfg))
    rng = np.random.default_rng(3)
    cand = rng.permutation(cfg.n_items)[:700].astype(np.int32)
    top_s, top_i = recsys.retrieval_step(p, b, torch.as_tensor(cand), cfg,
                                         top_k=10)
    j_s, j_i = jax_recsys.retrieval_step(jp, jb, jnp.asarray(cand), jcfg,
                                         top_k=10)
    assert top_i.dtype == torch.int32
    _close(top_s, j_s)
    # ids where the scores are distinct (ties may be ordered otherwise)
    s = np.asarray(j_s)
    distinct = np.ones_like(s, bool)
    distinct[:, 1:] &= np.abs(np.diff(s, axis=1)) > 1e-5
    distinct[:, :-1] &= np.abs(np.diff(s, axis=1)) > 1e-5
    assert distinct.any()
    assert np.array_equal(top_i.numpy()[distinct], np.asarray(j_i)[distinct])


@pytest.mark.parametrize("name", ["gin-tu", "gat-cora", "gatedgcn", "dcn-v2",
                                  "gcn"])
def test_param_specs_and_tree_init_match_jax(name):
    if name == "dcn-v2":
        jcfg = jax_get_arch(name).smoke_config
        cfg = convert.dcn_config_from(jcfg)
        jspecs, specs = (jax_recsys.dcn_param_specs(jcfg),
                         recsys.dcn_param_specs(cfg))
    else:
        jcfg = _jax_gnn_config(name, 0, 5)
        cfg = convert.gnn_config_from(jcfg)
        jspecs, specs = (jax_gnn.gnn_param_specs(jcfg),
                         gnn.gnn_param_specs(cfg))
    assert params.count_params(specs) == jax_params.count_params(jspecs)
    assert cfg.n_params() == jcfg.n_params()
    jtree = jax_params.tree_init(jax.random.PRNGKey(0), jspecs)
    tree = params.tree_init(specs, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    jleaves, jdef = jax.tree.flatten(jtree)
    leaves = [leaf for _, leaf in sorted(_flatten(tree))]
    assert [tuple(x.shape) for x in leaves] == [x.shape for x in jleaves]
    assert all(x.dtype == torch.float32 for x in leaves)
    assert [s.logical for s in params.tree_leaves(specs)] == [
        s.logical for s in jax.tree.leaves(jspecs, is_leaf=jax_params.is_spec)]
    again = params.tree_init(specs, generator=torch.Generator().manual_seed(0),
                             device="cpu")
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(
        sorted(_flatten(tree)), sorted(_flatten(again))))


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_init_rules():
    gen = torch.Generator().manual_seed(3)
    spec = params.ParamSpec
    tree = params.tree_init({
        "z": spec((4, 3), init="zeros"), "o": spec((5,), init="ones"),
        "e": spec((4000, 8), init="embed", scale=0.5),
        "n": spec((400, 100)), "b": spec((3, 2), torch.bfloat16)},
        generator=gen, device="cpu")
    assert torch.equal(tree["z"], torch.zeros(4, 3))
    assert torch.equal(tree["o"], torch.ones(5))
    assert abs(float(tree["e"].std()) - 0.5) < 0.01
    assert abs(float(tree["n"].std()) - 400 ** -0.5) < 0.002   # fan-in
    assert tree["b"].dtype == torch.bfloat16
    assert params.count_params({"a": spec((4, 3)), "b": {"c": spec((7,))}}) \
        == 19


def test_params_from_numpy_keeps_keys_layouts_and_bf16():
    jtree = {"a": jnp.arange(6, dtype=jnp.float32).reshape(2, 3),
             "nested": {"b": jnp.asarray([1.5, -2.25], jnp.bfloat16),
                        "c": jnp.asarray([[1], [2]], jnp.int32)}}
    tree = convert.params_from_numpy(jtree, "cpu")
    assert torch.equal(tree["a"], torch.arange(6.0).reshape(2, 3))
    assert tree["nested"]["b"].dtype == torch.bfloat16
    assert tree["nested"]["b"].tolist() == [1.5, -2.25]
    assert tree["nested"]["c"].dtype == torch.int32


@pytest.mark.parametrize("name", ["gin-tu", "gat-cora", "gatedgcn", "dcn-v2"])
def test_configs_match_jax(name):
    jarch, arch = jax_get_arch(name), configs.get_arch(name)
    assert (arch.name, arch.family) == (jarch.name, jarch.family)
    for jc, c in ((jarch.config, arch.config),
                  (jarch.smoke_config, arch.smoke_config)):
        want = dataclasses.asdict(jc)
        for field in convert.DROPPED_MODEL_FIELDS:
            want.pop(field, None)
        assert dataclasses.asdict(c) == want
        mapped = (convert.dcn_config_from(jc) if name == "dcn-v2"
                  else convert.gnn_config_from(jc))
        assert mapped == c
    assert [dataclasses.asdict(s) for s in arch.shapes] == [
        dataclasses.asdict(s) for s in jarch.shapes]
    if arch.family == "gnn":
        for s, js in zip(arch.shapes, jarch.shapes):
            assert (dataclasses.asdict(gnn_common._specialize(arch.config, s))
                    == {k: v for k, v in dataclasses.asdict(jax_specialize(
                        jarch.config, js)).items()
                        if k not in convert.DROPPED_MODEL_FIELDS})


def test_padded_sizes_match_jax_input_specs():
    from repro.configs.gnn_common import graph_input_specs

    for s in gnn_common.GNN_SHAPES:
        sds = graph_input_specs(s, with_positions=False)
        assert gnn_common.padded_sizes(s) == (sds["node_feat"].shape[0],
                                              sds["edge_src"].shape[0])
    assert gnn_common.padded_sizes(gnn_common.GNN_SHAPES[2]) == (
        2_449_032, 61_859_328)


def test_get_arch_for_ported_and_unported_names():
    assert configs.arch_names() == ["dcn-v2", "gat-cora", "gatedgcn",
                                    "gin-tu"]
    for name in ("granite-8b", "gemma3-1b", "qwen2-72b",
                 "moonshot-v1-16b-a3b", "arctic-480b", "equiformer-v2"):
        with pytest.raises(NotImplementedError, match="slice 9"):
            configs.get_arch(name)
    with pytest.raises(NotImplementedError, match="slice 10"):
        configs.get_arch("ptmt-mining")
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_arch("resnet-50")
    from repro.configs import arch_names as jax_arch_names

    assert sorted([*configs.arch_names(), *configs.UNPORTED]) == \
        jax_arch_names()


def test_synthetic_recsys_batch_matches_jax():
    kw = dict(batch=64, n_dense=13, n_sparse=4,
              vocab_sizes=(10, 1000, 7, 100_000))
    got = recsys_pipeline.synthetic_recsys_batch(np.random.default_rng(2),
                                                 **kw)
    want = jax_recsys_pipeline.synthetic_recsys_batch(
        np.random.default_rng(2), **kw)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


def test_entry_points_need_a_device_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graph_data.random_graph_batch(n_nodes=4, n_edges=4, d_feat=2,
                                      n_classes=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params.tree_init({"a": params.ParamSpec((2,))},
                         generator=torch.Generator())


def test_models_on_gpu_match_cpu():
    """Every GNN kind and DCN-v2 on the card (through B4 and B5) against
    the same forward on the CPU; skips on a host without one
    (chip_smoke.py runs them at full width there)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py covers the models")
    torch.backends.cuda.matmul.allow_tf32 = False
    for name in GNN_CASES:
        cfg = convert.gnn_config_from(_jax_gnn_config(name, 0, 5))
        p = params.tree_init(gnn.gnn_param_specs(cfg),
                             generator=torch.Generator().manual_seed(0),
                             device="cpu")
        _, g = _graphs(0, 5)
        want = gnn.forward(p, g, cfg)
        got = gnn.forward({k: _to(v) for k, v in p.items()},
                          {k: v.cuda() for k, v in g.items()}, cfg)
        _close(got.cpu(), want.numpy(), rtol=1e-4)
    _, cfg, _, p = _dcn()
    _, b = _dcn_batch(cfg, 32)
    want = recsys.forward(p, b, cfg)
    got = recsys.forward({k: _to(v) for k, v in p.items()},
                         {k: v.cuda() for k, v in b.items()}, cfg)
    _close(got.cpu(), want.numpy())


def test_dcn_x0_is_one_grouped_bag_call(monkeypatch):
    """interact_features builds x0 with one call of the grouped embedding
    bag over the first n_sparse fields (no per-field calls, no concat),
    and it equals the per-field bags after the dense columns."""
    _, cfg, _, p = _dcn()
    _, b = _dcn_batch(cfg, 16, seed=4)
    calls = []
    orig = bag_ops.embedding_bag_fields
    monkeypatch.setattr(bag_ops, "embedding_bag_fields",
                        lambda *a: calls.append(a) or orig(*a))
    x0 = recsys.interact_features(p, b["dense"], b["sparse_ids"],
                                  b["sparse_weights"], cfg)
    assert len(calls) == 1 and len(calls[0][0]) == cfg.n_sparse
    want = torch.cat([b["dense"]] + [
        recsys.embedding_bag(p["tables"][f"t{i}"], b["sparse_ids"][:, i],
                             b["sparse_weights"][:, i])
        for i in range(cfg.n_sparse)], dim=-1)
    assert x0.shape == (16, cfg.d_interact) and torch.equal(x0, want)


def test_dcn_forward_launches_one_bag_kernel_on_gpu():
    """One B5 launch per forward, query embedding and retrieval step on
    the card; skips on a host without one (chip_smoke.py counts them at
    full width there)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py counts the launches")
    _, cfg, _, p = _dcn()
    _, b = _dcn_batch(cfg, 32)
    p, b = _to(p), {k: v.cuda() for k, v in b.items()}
    cand = torch.arange(100, dtype=torch.int32, device="cuda")
    for run in (lambda: recsys.forward(p, b, cfg),
                lambda: recsys.query_embedding(p, b, cfg),
                lambda: recsys.retrieval_step(p, b, cand, cfg, top_k=5)):
        bag_ops.reset_launches()
        run()
        assert bag_ops.launches == {"embedding_bag": 0,
                                    "embedding_bag_fields": 1,
                                    "embedding_bag_fields_backward": 0}


def _to(x):
    return {k: _to(v) for k, v in x.items()} if isinstance(x, dict) \
        else x.cuda()
