"""Wrapper of the embedding-bag kernel (B5), dispatching on device.

``csrc/embedding_bag.cu`` replaces the TPU kernel ``embedding_bag_pallas``
of the JAX package.  One C function, ``embedding_bag_fields``, computes the
bags of every sparse field of a batch and writes them, after the dense
columns, straight into ``x0``: :func:`embedding_bag_fields` is DCN-v2's one
launch per forward, and :func:`embedding_bag` (one field, the JAX
``ops.embedding_bag`` signature) is the same kernel with one field and no
dense columns.  For CUDA tensors a wrapper launches it on PyTorch's
current stream (built with ``nvcc`` at first use, see :mod:`.._build`) or
raises; for CPU tensors — the tests' only device — it runs the plain
version in :mod:`.ref`.  :data:`launches` counts kernel launches per
wrapper and nothing else.

:func:`embedding_bag_fields` and its transpose are ``torch.library``
custom ops, ``torch.ops.repro_torch.embedding_bag_fields`` and
``torch.ops.repro_torch.embedding_bag_fields_backward``, each with a CUDA
kernel (the launch) and a CPU kernel (the plain version), a fake
implementation (their shapes, for the dry run's fake tensors) and a FLOP
formula (``2 B F K D``).  The forward's autograd is the transpose with
respect to the tables — the C function ``embedding_bag_fields_backward``
(all fields in one launch, fp32 atomics) on CUDA, one ``index_add_`` per
field on the CPU — and the dense columns of the output gradient with
respect to ``dense``; ids and weights get no gradient.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from . import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "embedding_bag.cu"

#: kernel launches per wrapper since the last :func:`reset_launches`
launches = {"embedding_bag": 0, "embedding_bag_fields": 0,
            "embedding_bag_fields_backward": 0}

#: table and x0 dtypes the kernel takes -> its dtype code
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "embedding_bag_fields": ([_P, _P, _I] + [_P] * 4 + [_L, _L, _I]
                             + [_L] * 4 + [_I, _L, _I, _I, _I, _P]),
    "embedding_bag_fields_backward": ([_P, _P, _I] + [_P] * 3
                                      + [_L, _L, _I] + [_L] * 4
                                      + [_I, _I, _I, _P]),
}
_fns: dict[str, object] = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _kernel(name: str = "embedding_bag_fields"):
    fn = _fns.get(name)
    if fn is None:
        from repro_torch.kernels import _build

        fn = getattr(_build.load(SOURCE), name)
        fn.restype = ctypes.c_int
        fn.argtypes = _SIGNATURES[name]
        _fns[name] = fn
    return fn


def _bags(x, dtype):
    """``x [B, F, K]`` as the kernel reads it: ``dtype``, k contiguous;
    a view with bag and field strides stays a view."""
    x = x.to(dtype)
    return x if x.stride(2) == 1 or x.shape[2] == 1 else x.contiguous()


class _Tables:
    """The tables as the kernel takes them (pointers and vocabulary sizes
    by value), filled table by table by :func:`ref.check_fields`'s one
    pass over them."""

    def __init__(self, tables):
        n = len(tables)
        self.ptrs = (ctypes.c_void_p * n)()
        self.vocabs = (ctypes.c_longlong * n)()
        self.device = tables[0].device if n else None
        self.keep = []          # contiguous copies, alive until the launch

    def __call__(self, f, t):
        if not t.is_cuda:
            raise ValueError("the embedding-bag kernel needs CUDA tensors")
        if t.device != self.device:
            raise ValueError(f"table {f} is on {t.device}, expected "
                             f"{self.device} like table 0")
        if t.dtype not in DTYPES:
            raise TypeError(f"table has dtype {t.dtype}, expected one of "
                            f"{list(DTYPES)}")
        if not t.is_contiguous():
            t = t.contiguous()
            self.keep.append(t)
        self.ptrs[f], self.vocabs[f] = t.data_ptr(), t.shape[0]


def _launch(tabs, d, dtype, ids, weights, dense, out_dtype, out=None):
    """One launch over CUDA tensors of tables ``tabs`` (a filled
    :class:`_Tables`): x0 ``[B, n_dense + F * D]``, into ``out`` when
    given (columns contiguous, rows may be strided)."""
    if out_dtype not in DTYPES:
        raise TypeError(f"x0 has dtype {out_dtype}, expected one of "
                        f"{list(DTYPES)}")
    if ids.dtype != torch.int32:
        raise TypeError(f"ids has dtype {ids.dtype}, expected int32")
    dev = tabs.device
    for name, x in (("ids", ids), ("weights", weights), ("dense", dense),
                    ("out", out)):
        if x is not None and x.device != dev:
            raise ValueError(f"{name} is on {x.device}, expected {dev} like "
                             "table 0")
    n_fields = len(tabs.ptrs)
    n_dense = 0 if dense is None else dense.shape[1]
    ids, weights = _bags(ids, torch.int32), _bags(weights, torch.float32)
    if dense is not None:
        dense = dense.to(out_dtype)
        if dense.stride(1) != 1 and n_dense > 1:
            dense = dense.contiguous()
    b, _, k = ids.shape
    shape = (b, n_dense + n_fields * d)
    if out is None:
        out = torch.empty(shape, dtype=out_dtype, device=dev)
    elif (out.shape != shape or out.dtype != out_dtype
          or (out.stride(1) != 1 and shape[1] > 1)):
        raise ValueError(f"out is {out.dtype} {tuple(out.shape)} with "
                         f"strides {out.stride()}, expected {out_dtype} "
                         f"{shape} with contiguous columns")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel()(
            tabs.ptrs, tabs.vocabs, n_fields,
            None if dense is None else dense.data_ptr(), ids.data_ptr(),
            weights.data_ptr(), out.data_ptr(), out.stride(0), b, k,
            ids.stride(0), ids.stride(1), weights.stride(0),
            weights.stride(1), n_dense,
            0 if dense is None else dense.stride(0), d, DTYPES[dtype],
            DTYPES[out_dtype], stream)
    if err == -1:
        raise ValueError(
            f"embedding_bag_fields refused {n_fields} fields of width {d} "
            f"with {n_dense} dense columns in {out_dtype}: it takes at most "
            "64 fields and an x0 row that fits 48 KB of shared memory")
    if err != 0:
        raise RuntimeError(f"embedding_bag_fields launch failed with CUDA "
                           f"error {err}")
    return out


def launch_kernel(table, ids, weights, out=None):
    """Launch B5 for one field on CUDA tensors; raises on anything else.

    table ``[V, D]`` f32 or bf16, ids int32 ``[B, K]``, weights ``[B, K]``
    (taken as f32) -> ``[B, D]`` in the table's dtype, written into
    ``out`` when given (see :func:`embedding_bag`).
    """
    ref.check_inputs(table, ids, weights)
    tabs = _Tables([table])
    tabs(0, table)
    out = _launch(tabs, table.shape[1], table.dtype, ids[:, None],
                  weights[:, None], None, table.dtype, out)
    launches["embedding_bag"] += 1
    return out


def launch_fields_kernel(tables, ids, weights, dense=None):
    """Launch B5 for every field at once on CUDA tensors, writing x0;
    raises on anything else (see :func:`embedding_bag_fields`)."""
    tabs = _Tables(tables)
    out_dtype = ref.check_fields(tables, ids, weights, dense, each=tabs)
    out = _launch(tabs, tables[0].shape[1], tables[0].dtype, ids, weights,
                  dense, out_dtype)
    launches["embedding_bag_fields"] += 1
    return out


def launch_fields_backward_kernel(tables, ids, weights, grad_x0,
                                  n_dense: int, into=None):
    """Launch B5's transpose on CUDA tensors; raises on anything else.

    ``grad_x0 [B, n_dense + F * D]`` (f32 or bf16) is the gradient of
    :func:`embedding_bag_fields`'s output; returns one float32 gradient
    ``[V_f, D]`` per table, filled by one launch for all fields: zeros
    made here, or the contiguous float32 buffers ``into`` (one per
    table), added to in place."""
    n_fields, d = len(tables), tables[0].shape[1]
    if grad_x0.dtype not in DTYPES:
        raise TypeError(f"grad_x0 has dtype {grad_x0.dtype}, expected one "
                        f"of {list(DTYPES)}")
    if grad_x0.shape != (ids.shape[0], n_dense + n_fields * d):
        raise ValueError(f"grad_x0 has shape {tuple(grad_x0.shape)}, "
                         f"expected {(ids.shape[0], n_dense + n_fields * d)}")
    if into is None:
        grads = [torch.zeros((t.shape[0], d), dtype=torch.float32,
                             device=t.device) for t in tables]
    else:
        grads = list(into)
        for f, (g, t) in enumerate(zip(grads, tables, strict=True)):
            if (g.shape != (t.shape[0], d) or g.dtype != torch.float32
                    or not g.is_contiguous()):
                raise ValueError(f"into[{f}] is {g.dtype} "
                                 f"{tuple(g.shape)}, expected a contiguous "
                                 f"float32 {(t.shape[0], d)}")
    bufs = _Tables(grads)
    for f, g in enumerate(grads):
        bufs(f, g)
    for name, x in (("ids", ids), ("weights", weights),
                    ("grad_x0", grad_x0)):
        if x.device != bufs.device:
            raise ValueError(f"{name} is on {x.device}, expected "
                             f"{bufs.device} like table 0")
    ids, weights = _bags(ids, torch.int32), _bags(weights, torch.float32)
    if grad_x0.stride(1) != 1:
        grad_x0 = grad_x0.contiguous()
    b, _, k = ids.shape
    with torch.cuda.device(bufs.device):
        stream = torch.cuda.current_stream(bufs.device).cuda_stream
        err = _kernel("embedding_bag_fields_backward")(
            bufs.ptrs, bufs.vocabs, n_fields, ids.data_ptr(),
            weights.data_ptr(), grad_x0.data_ptr(), grad_x0.stride(0), b, k,
            ids.stride(0), ids.stride(1), weights.stride(0),
            weights.stride(1), n_dense, d, DTYPES[grad_x0.dtype], stream)
    if err == -1:
        raise ValueError(f"embedding_bag_fields_backward refused "
                         f"{n_fields} fields: it takes at most 64")
    if err != 0:
        raise RuntimeError(f"embedding_bag_fields_backward launch failed "
                           f"with CUDA error {err}")
    launches["embedding_bag_fields_backward"] += 1
    return grads


@torch.library.custom_op("repro_torch::embedding_bag_fields_backward",
                         mutates_args=(), device_types="cpu")
def fields_backward(tables: list[torch.Tensor], ids: torch.Tensor,
                    weights: torch.Tensor, grad_x0: torch.Tensor,
                    n_dense: int) -> list[torch.Tensor]:
    """The tables' gradients of :func:`embedding_bag_fields`, each in its
    table's dtype: the kernel on CUDA, one ``index_add_`` per field on the
    CPU; both sum in fp32 and cast once."""
    grads = ref.embedding_bag_fields_backward(
        [t.shape[0] for t in tables], ids, weights, grad_x0, n_dense)
    return [g.to(t.dtype) for g, t in zip(grads, tables)]


@fields_backward.register_kernel("cuda")
def _fields_backward_cuda(tables, ids, weights, grad_x0, n_dense):
    grads = launch_fields_backward_kernel(tables, ids, weights, grad_x0,
                                          n_dense)
    return [g.to(t.dtype) for g, t in zip(grads, tables)]


@fields_backward.register_fake
def _(tables, ids, weights, grad_x0, n_dense):
    d = tables[0].shape[1]
    return [t.new_empty((t.shape[0], d)) for t in tables]


@torch.library.custom_op("repro_torch::embedding_bag_fields",
                         mutates_args=(), device_types="cpu")
def _fields(tables: list[torch.Tensor], ids: torch.Tensor,
            weights: torch.Tensor, dense: Optional[torch.Tensor]
            ) -> torch.Tensor:
    """x0 of every field; on the CPU the plain version."""
    return ref.embedding_bag_fields(tables, ids, weights, dense)


@_fields.register_kernel("cuda")
def _fields_cuda(tables, ids, weights, dense):
    return launch_fields_kernel(tables, ids, weights, dense)


@_fields.register_fake
def _(tables, ids, weights, dense):
    out_dtype = ref.check_fields(tables, ids, weights, dense)
    n_dense = 0 if dense is None else dense.shape[1]
    return tables[0].new_empty(
        (ids.shape[0], n_dense + len(tables) * tables[0].shape[1]),
        dtype=out_dtype)


@register_flop_formula([torch.ops.repro_torch.embedding_bag_fields,
                        torch.ops.repro_torch.embedding_bag_fields_backward])
def _fields_flops(tables_shape, ids_shape, *args, out_shape=None,
                  **kwargs) -> int:
    """A multiply and an add per id and column: ``2 B F K D``."""
    b, f, k = ids_shape
    return 2 * b * f * k * tables_shape[0][1]


def _fields_setup(ctx, inputs, output):
    tables, ids, weights, dense = inputs
    ctx.save_for_backward(ids, weights)
    ctx.tables = tables
    ctx.dense_dtype = None if dense is None else dense.dtype
    ctx.n_dense = 0 if dense is None else dense.shape[1]


def _fields_backward(ctx, grad_x0):
    ids, weights = ctx.saved_tensors
    need_tables, _, _, need_dense = ctx.needs_input_grad
    grad_dense = (grad_x0[:, :ctx.n_dense].to(ctx.dense_dtype)
                  if need_dense else None)
    grads = None
    if any(need_tables):
        grads = [g if n else None for g, n in zip(
            fields_backward(ctx.tables, ids, weights, grad_x0, ctx.n_dense),
            need_tables)]
    return grads, None, None, grad_dense


_fields.register_autograd(_fields_backward, setup_context=_fields_setup)


def embedding_bag(table, ids, weights, out=None):
    """Weighted sum-bag lookup: table ``[V, D]``, ids ``[B, K]``, weights
    ``[B, K]`` -> ``[B, D]`` in the table's dtype.

    ``out``, if given, is a ``[B, D]`` tensor of the table's dtype with
    contiguous columns (rows may be strided: one field's columns of x0)
    that receives the bags and is returned.  CUDA tensors go to the
    kernel, CPU tensors to its plain version.
    """
    if table.is_cuda:
        return launch_kernel(table, ids, weights, out)
    if table.device.type != "cpu":
        raise ValueError(f"unsupported device {table.device}")
    bags = ref.embedding_bag(table, ids, weights)
    if out is None:
        return bags
    if out.shape != bags.shape or out.dtype != bags.dtype:
        raise ValueError(f"out is {out.dtype} {tuple(out.shape)}, expected "
                         f"{bags.dtype} {tuple(bags.shape)}")
    return out.copy_(bags)


def embedding_bag_fields(tables, ids, weights, dense=None):
    """``x0 = [dense || bag_0 || ... || bag_{F-1}]`` in one launch.

    Args:
      tables: F tables ``[V_f, D]`` of one dtype and one ``D``.
      ids: integer ``[B, F, K]``; ``weights``: ``[B, F, K]``.
      dense: ``[B, n_dense]`` or None.
    Returns:
      ``[B, n_dense + F * D]``: each field's bag in the tables' dtype,
      after the dense columns, in the dtype ``torch.cat`` gives them.
      CUDA tensors go to the kernel, CPU tensors to its plain version,
      forward and backward.  Differentiable in the tables and ``dense``;
      ``weights`` that require a gradient raise, since none is computed.
    """
    if weights.requires_grad and torch.is_grad_enabled():
        raise ValueError("embedding_bag_fields computes no gradient for "
                         "weights; detach them")
    first = tables[0] if len(tables) else None
    if first is not None and first.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {first.device}")
    return _fields(list(tables), ids, weights, dense)
