"""B4 and B5 as ``torch.library`` custom ops: ``opcheck`` of each op (its
schema, fake and autograd registrations), the FLOP formulas, and the GNN
and DCN-v2 models through the ops against the ``torch.autograd.Function``s
that wrapped the kernels before them (``_SegmentSum`` and ``_BagFields``,
kept here as their CPU paths were), output and gradients bit for bit on
the CPU.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.library import opcheck
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_arch, gnn_common
from repro_torch.data import graph_data
from repro_torch.kernels.embedding_bag import ops as bag_ops
from repro_torch.kernels.embedding_bag import ref as bag_ref
from repro_torch.kernels.segment_spmm import ops as spmm_ops
from repro_torch.kernels.segment_spmm import ref as spmm_ref
from repro_torch.models import gnn, params, recsys
from repro_torch.training.tree import leaves, value_and_grad

N, E, F_IN, PAD_N, PAD_E = 48, 160, 12, 56, 200


def _graph_plan(seed=0, d=8):
    g = torch.Generator().manual_seed(seed)
    dst = torch.randint(-2, N + 2, (E,), generator=g, dtype=torch.int32)
    src = torch.randint(0, N, (E,), generator=g, dtype=torch.int32)
    mask = torch.rand(E, generator=g) > 0.2
    plan = spmm_ops.plan(dst, N, mask)
    x = torch.randn(N, d, generator=g, requires_grad=True)
    v = torch.randn(E, d, generator=g, requires_grad=True)
    return plan, plan.compose(src), x, v


def _bag_case(seed=0, dense=True):
    g = torch.Generator().manual_seed(seed)
    vocabs, b, k, d = (7, 5, 9), 6, 3, 4
    tables = [torch.randn(v, d, generator=g, requires_grad=True)
              for v in vocabs]
    ids = torch.stack([torch.randint(-(v // 4), v, (b, k), generator=g)
                       for v in vocabs], 1).to(torch.int32)
    w = torch.rand(b, len(vocabs), k, generator=g)
    den = torch.randn(b, 2, generator=g, requires_grad=True) if dense \
        else None
    return tables, ids, w, den


def _spmm_cases():
    plan, rows, x, v = _graph_plan()
    tp, tr = spmm_ops.transpose(plan, rows, N)
    base = (plan.sorted_ids, plan.offsets, N)
    return {
        "per_edge": (v, plan.order, *base, True, None, None, None, False),
        "rows": (x, rows, *base, False, None, None, None, False),
        "rows_transposed": (x, rows, *base, False, tr, tp.sorted_ids,
                            tp.offsets, False),
        "backward": (x.detach(), rows, *base, False, None, None, None,
                     True),
    }


@pytest.mark.parametrize("case", ["per_edge", "rows", "rows_transposed",
                                  "backward"])
def test_segment_spmm_passes_opcheck(case):
    assert opcheck(torch.ops.repro_torch.segment_spmm.default,
                   _spmm_cases()[case]) == dict.fromkeys(
        ("test_schema", "test_autograd_registration", "test_faketensor",
         "test_aot_dispatch_dynamic"), "SUCCESS")


def test_segment_bounds_passes_opcheck():
    plan, *_ = _graph_plan()
    for n in (N, 0, 3 * N):
        opcheck(torch.ops.repro_torch.segment_bounds.default,
                (plan.sorted_ids, n))
        got = torch.ops.repro_torch.segment_bounds(plan.sorted_ids, n)
        assert got.dtype == torch.int64 and got.shape == (n + 1,)


@pytest.mark.parametrize("dense", [True, False])
def test_embedding_bag_fields_passes_opcheck(dense):
    tables, ids, w, den = _bag_case(dense=dense)
    opcheck(torch.ops.repro_torch.embedding_bag_fields.default,
            (tables, ids, w, den))
    grad_x0 = torch.randn(ids.shape[0], (2 if dense else 0) + 3 * 4)
    opcheck(torch.ops.repro_torch.embedding_bag_fields_backward.default,
            ([t.detach() for t in tables], ids, w, grad_x0,
             2 if dense else 0))


def test_flop_formulas_count_the_ops_on_fake_tensors():
    """``FlopCounterMode`` counts B4 as one add per position and column
    (forward and the backward on the transposed plan) and B5 as
    ``2 B F K D`` each way, on real and on fake tensors alike."""
    plan, rows, x, v = _graph_plan()
    tables, ids, w, den = _bag_case()
    want = 2 * E * 8 + 2 * 2 * 6 * 3 * 3 * 4
    for fake in (False, True):
        mode = FakeTensorMode(allow_non_fake_inputs=True)
        with mode if fake else contextlib.nullcontext():
            x_, t_, d_ = x, tables, den
            if fake:
                x_, d_ = mode.from_tensor(x), mode.from_tensor(den)
                t_ = [mode.from_tensor(t) for t in tables]
            with FlopCounterMode(display=False) as fc:
                spmm_ops.segment_sum(x_, plan, rows).sum().backward()
                bag_ops.embedding_bag_fields(t_, ids, w, d_).sum() \
                    .backward()
        assert fc.get_total_flops() == want, fake


# -- the autograd Functions the custom ops replace, as they were -----------

class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, seg_plan, rows, transposed):
        ctx.seg_plan, ctx.rows, ctx.transposed = seg_plan, rows, transposed
        ctx.n_rows = values.shape[0]
        rows = seg_plan.order if rows is None else rows
        return spmm_ref.segment_sum(values, rows, seg_plan.sorted_ids,
                                    seg_plan.num_segments)

    @staticmethod
    def backward(ctx, grad):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None
        if ctx.rows is None:
            return spmm_ops.edge_grad(grad, ctx.seg_plan), None, None, None
        transposed = ctx.transposed or spmm_ops.transpose(
            ctx.seg_plan, ctx.rows, ctx.n_rows)
        t_plan, t_rows = transposed
        return spmm_ref.segment_sum(grad.contiguous(), t_rows,
                                    t_plan.sorted_ids, t_plan.num_segments), \
            None, None, None


class _BagFields(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ids, weights, dense, *tables):
        ctx.save_for_backward(ids, weights)
        ctx.tables = tables
        ctx.dense_dtype = None if dense is None else dense.dtype
        ctx.n_dense = 0 if dense is None else dense.shape[1]
        return bag_ref.embedding_bag_fields(tables, ids, weights, dense)

    @staticmethod
    def backward(ctx, grad_x0):
        ids, weights = ctx.saved_tensors
        need = ctx.needs_input_grad
        grad_dense = (grad_x0[:, :ctx.n_dense].to(ctx.dense_dtype)
                      if need[2] else None)
        grads = [None] * len(ctx.tables)
        if any(need[3:]):
            grads = [g.to(t.dtype) if n else None for g, t, n in zip(
                bag_ref.embedding_bag_fields_backward(
                    [t.shape[0] for t in ctx.tables], ids, weights,
                    grad_x0, ctx.n_dense), ctx.tables, need[3:])]
        return (None, None, grad_dense, *grads)


def _through_functions(monkeypatch):
    monkeypatch.setattr(spmm_ops, "segment_sum", lambda values, seg_plan,
                        rows=None, transposed=None: _SegmentSum.apply(
                            values, seg_plan, rows, transposed))
    monkeypatch.setattr(bag_ops, "embedding_bag_fields",
                        lambda tables, ids, weights, dense=None:
                        _BagFields.apply(ids, weights, dense, *tables))


def _bitwise(a_tree, b_tree):
    a, b = leaves(a_tree), leaves(b_tree)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("name,readout", [
    ("gin-tu", "node"), ("gin-tu", "graph"), ("gat-cora", "node"),
    ("gatedgcn", "node"), ("gcn", "graph")])
def test_gnn_through_the_ops_equals_the_functions_bitwise(name, readout,
                                                          monkeypatch):
    n_graphs, n_classes = (4, 3) if readout == "graph" else (0, 5)
    base = get_arch("gin-tu" if name == "gcn" else name).smoke_config
    if name == "gcn":
        base = dataclasses.replace(base, name="gcn-smoke", kind="gcn")
    for remat in (False, True):
        cfg = dataclasses.replace(gnn_common._specialize(
            base, gnn_common.GNNShape("tiny", PAD_N, PAD_E, F_IN, n_classes,
                                      n_graphs=n_graphs)), remat=remat)
        g = graph_data.random_graph_batch(
            n_nodes=N, n_edges=E, d_feat=F_IN, n_classes=n_classes,
            n_graphs=n_graphs, seed=11, pad_nodes=PAD_N, pad_edges=PAD_E,
            device="cpu")
        p = params.tree_init(gnn.gnn_param_specs(cfg),
                             generator=torch.Generator().manual_seed(0),
                             device="cpu")
        with torch.no_grad():
            out = gnn.forward(p, g, cfg)
        got = value_and_grad(gnn.loss_fn)(p, g, cfg)
        with monkeypatch.context() as m:
            _through_functions(m)
            with torch.no_grad():
                want_out = gnn.forward(p, g, cfg)
            want = value_and_grad(gnn.loss_fn)(p, g, cfg)
        assert torch.equal(out, want_out)
        _bitwise(got, want)


def test_dcn_through_the_op_equals_the_function_bitwise(monkeypatch):
    cfg = get_arch("dcn-v2").smoke_config
    p = params.tree_init(recsys.dcn_param_specs(cfg),
                         generator=torch.Generator().manual_seed(0),
                         device="cpu")
    rng = np.random.default_rng(0)
    b = 32
    batch = {
        "dense": torch.as_tensor(rng.standard_normal(
            (b, cfg.n_dense)).astype(np.float32)),
        "sparse_ids": torch.as_tensor(np.stack([rng.integers(
            -(v // 4), v, (b, cfg.bag_size)) for v in cfg.vocab_sizes],
            1).astype(np.int32)),
        "sparse_weights": torch.as_tensor(rng.uniform(0.0, 1.0, (
            b, cfg.n_sparse, cfg.bag_size)).astype(np.float32)),
        "labels": torch.as_tensor(rng.integers(0, 2, b).astype(np.float32)),
    }
    with torch.no_grad():
        out = recsys.forward(p, batch, cfg)
    got = value_and_grad(recsys.loss_fn)(p, batch, cfg)
    with monkeypatch.context() as m:
        _through_functions(m)
        with torch.no_grad():
            want_out = recsys.forward(p, batch, cfg)
        want = value_and_grad(recsys.loss_fn)(p, batch, cfg)
    assert torch.equal(out, want_out)
    _bitwise(got, want)
