"""Wrapper of the segment scatter-sum kernel (B4), dispatching on device.

``csrc/segment_spmm.cu`` replaces the TPU kernel
``scatter_sum_sorted_pallas`` of the JAX package.  Like the JAX wrapper,
:func:`plan` gives every masked or out-of-range row the sentinel id
``num_segments`` and takes a stable argsort by id; it does so once per
graph, and every :func:`segment_sum` over the same destinations reuses the
plan.  The kernel reads each row through a row index — the plan's
permutation for per-edge values, or the permutation composed with the edge
sources (:meth:`SegmentPlan.compose`) to sum ``h[src]`` straight from the
node rows of ``h`` — so neither a sorted copy of the values nor the
``[E, D]`` gathered messages are made.

The kernel's two entry points are ``torch.library`` custom ops,
``torch.ops.repro_torch.segment_bounds`` (a plan's offsets) and
``torch.ops.repro_torch.segment_spmm`` (the sum), so fake tensors trace
them (``register_fake`` gives their shapes), ``FlopCounterMode`` counts
them (one add per position and column) and autograd differentiates the
sum on every device, the CPU tests running the backward that runs on the
card.  Its gradient with respect to per-edge values (rows = the plan's
permutation) is a masked gather of the output gradient by destination;
with respect to node rows read through a row index
(``plan.compose(src)``) it is the same op on the transposed plan
(:func:`transpose`): each kept position adds the output gradient's row of
its segment into the row it read.

Each op has a CUDA kernel, which launches the kernel on PyTorch's current
stream (built with ``nvcc`` at first use, see :mod:`.._build`) or raises,
and a CPU kernel, the plain version (:mod:`.ref`) — the tests' only
device; any other device raises.  :data:`launches` counts launches of the
sum kernel and nothing else, the backward's apart from the forward's;
:data:`plans` counts plans built, on any device (on CUDA each one
launches the kernel's bounds pass), the transposed plans of the backward
apart.
"""

from __future__ import annotations

import ctypes
import dataclasses
from pathlib import Path
from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from . import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "segment_spmm.cu"

#: kernel launches since the last :func:`reset_launches` (forward sums;
#: the backward's sums on transposed plans)
launches = {"segment_spmm": 0, "segment_spmm_backward": 0}
#: segment plans built since the last :func:`reset_launches`
plans = {"segment_plan": 0, "segment_plan_backward": 0}

#: value dtypes the kernel takes -> its dtype code
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: sorted positions per chunk: a segment with more runs on one warp per
#: chunk, and its fp32 partial sums are added in a second pass
CHUNK_ROWS = 1024
_INT32_MAX = 2**31 - 1

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "segment_bounds": [_P, _L, _I, _P, _P],
    "segment_spmm": [_P] * 6 + [_L, _I, _I, _L, _I, _I, _P],
}
_fns: dict[str, object] = {}


def reset_launches() -> None:
    for counts in (launches, plans):
        for name in counts:
            counts[name] = 0


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        from repro_torch.kernels import _build

        fn = getattr(_build.load(SOURCE), name)
        fn.restype = ctypes.c_int
        fn.argtypes = _SIGNATURES[name]
        _fns[name] = fn
    return fn


def _call(name: str, device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _kernel(name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")


@dataclasses.dataclass(frozen=True)
class SegmentPlan:
    """One stable sort of a graph's destination ids, shared by every
    aggregation over them.

    ``sorted_ids int32[E]``: the kept ids ascending, dropped rows at the
    sentinel ``num_segments`` (last); ``order int32[E]``: the stable
    permutation that sorts them; ``offsets int64[N + 1]``: segment ``s``
    is sorted positions ``[offsets[s], offsets[s + 1])``.
    """

    sorted_ids: torch.Tensor
    order: torch.Tensor
    offsets: torch.Tensor
    num_segments: int

    def compose(self, index):
        """``index[order]`` as int32: the row index that reads
        ``values[index[e]]`` for each edge ``e`` in the plan's sorted
        order (``index`` the edge sources: sum ``h[src]`` from ``h``)."""
        if index.shape != self.order.shape:
            raise ValueError(f"index has shape {tuple(index.shape)}, "
                             f"expected {tuple(self.order.shape)}")
        return index.to(torch.int32).index_select(0, self.order)


def _check_device(x) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def plan(segment_ids, num_segments: int, mask=None, *,
         count: str = "segment_plan") -> SegmentPlan:
    """Sort ``segment_ids [E]`` (masked and out-of-range rows to the
    sentinel) once, for every :func:`segment_sum` over them.

    On CUDA the offsets come from the kernel's bounds pass, on the CPU
    from ``torch.searchsorted``; the stable sort is ``torch.sort`` (the
    JAX wrapper's ``jnp.argsort``, which lies outside the TPU kernel too).
    """
    if segment_ids.dim() != 1:
        raise ValueError(f"segment_ids has shape {tuple(segment_ids.shape)}"
                         ", expected [E]")
    if mask is not None and mask.shape != segment_ids.shape:
        raise ValueError(f"mask has shape {tuple(mask.shape)}, "
                         f"expected {tuple(segment_ids.shape)}")
    if not 0 <= num_segments < _INT32_MAX:
        raise ValueError(f"num_segments {num_segments} outside "
                         f"[0, {_INT32_MAX})")
    if segment_ids.shape[0] > _INT32_MAX:
        raise ValueError("more than 2^31 - 1 rows")
    _check_device(segment_ids)
    ids = ref.kept_ids(segment_ids.to(torch.int32), num_segments, mask)
    sorted_ids, order = torch.sort(ids, stable=True)
    order = order.to(torch.int32)
    offsets = torch.ops.repro_torch.segment_bounds(sorted_ids, num_segments)
    plans[count] += 1
    return SegmentPlan(sorted_ids, order, offsets, num_segments)


@torch.library.custom_op("repro_torch::segment_bounds", mutates_args=(),
                         device_types="cpu")
def _bounds(sorted_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``offsets int64[num_segments + 1]`` of ascending ``sorted_ids``:
    on the CPU ``torch.searchsorted``."""
    return torch.searchsorted(sorted_ids, torch.arange(
        num_segments + 1, dtype=torch.int32, device=sorted_ids.device))


@_bounds.register_kernel("cuda")
def _bounds_cuda(sorted_ids, num_segments):
    """The kernel's bounds pass."""
    offsets = torch.empty(num_segments + 1, dtype=torch.int64,
                          device=sorted_ids.device)
    _call("segment_bounds", sorted_ids.device, sorted_ids.data_ptr(),
          sorted_ids.shape[0], num_segments, offsets.data_ptr())
    return offsets


@_bounds.register_fake
def _(sorted_ids, num_segments):
    return sorted_ids.new_empty(num_segments + 1, dtype=torch.int64)


def transpose(seg_plan: SegmentPlan, rows, n_rows: int):
    """The plan and row index of the transposed sum: ``(t_plan, t_rows)``
    such that ``segment_sum(grad, t_plan, t_rows)`` adds, for every kept
    sorted position ``r``, ``grad[sorted_ids[r]]`` into row ``rows[r]``
    of ``[n_rows, D]`` — the gradient of ``segment_sum(values, seg_plan,
    rows)`` with respect to ``values [n_rows, D]``.  With ``rows =
    plan(dst).compose(src)`` it sorts by source what the forward sorted by
    destination."""
    kept = seg_plan.sorted_ids < seg_plan.num_segments
    t_plan = plan(rows, n_rows, kept, count="segment_plan_backward")
    # a dropped position reads row 0 (never added: it sorts last)
    return t_plan, t_plan.compose(torch.where(kept, seg_plan.sorted_ids, 0))


def launch_kernel(values, seg_plan: SegmentPlan, rows,
                  chunk: int = CHUNK_ROWS, *, count: str = "segment_spmm"):
    """Launch B4 on CUDA tensors; raises on anything else.

    Sorted position ``r`` adds row ``rows[r]`` (int32, each in ``[0, R)``)
    of ``values [R, D]`` (f32 or bf16) into segment
    ``seg_plan.sorted_ids[r]``; positions at the sentinel are dropped.
    Segments longer than ``chunk`` positions are split into chunks.
    Returns ``[num_segments, D]`` in the values' dtype.  ``count`` names
    the entry of :data:`launches` the launch adds one to.
    """
    if not values.is_cuda:
        raise ValueError("the segment scatter-sum kernel needs CUDA tensors")
    if values.dtype not in DTYPES:
        raise TypeError(f"values has dtype {values.dtype}, expected one of "
                        f"{list(DTYPES)}")
    if values.dim() != 2:
        raise ValueError(f"values has shape {tuple(values.shape)}, "
                         "expected [R, D]")
    if chunk < 1:
        raise ValueError("chunk must be >= 1")
    n_pos = seg_plan.order.shape[0]
    if rows.shape != (n_pos,):
        raise ValueError(f"rows has shape {tuple(rows.shape)}, expected "
                         f"({n_pos},)")
    for name, x, dtype in (("rows", rows, torch.int32),
                           ("sorted_ids", seg_plan.sorted_ids, torch.int32),
                           ("offsets", seg_plan.offsets, torch.int64)):
        if x.device != values.device:
            raise ValueError(f"{name} is on {x.device}, expected "
                             f"{values.device} like values")
        if x.dtype != dtype:
            raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    values, rows = values.contiguous(), rows.contiguous()
    d = values.shape[1]
    n = seg_plan.num_segments
    dev = values.device
    vec = (d % (16 // values.element_size()) == 0
           and values.data_ptr() % 16 == 0)
    n_chunks = -(-n_pos // chunk)
    partial = torch.empty((2 * n_chunks, d), dtype=torch.float32, device=dev)
    out = torch.empty((n, d), dtype=values.dtype, device=dev)
    _call("segment_spmm", dev, values.data_ptr(), rows.data_ptr(),
          seg_plan.sorted_ids.data_ptr(), seg_plan.offsets.data_ptr(),
          partial.data_ptr(), out.data_ptr(), n_pos, d, n, chunk,
          DTYPES[values.dtype], int(vec))
    launches[count] += 1
    return out


@torch.library.custom_op("repro_torch::segment_spmm", mutates_args=(),
                         device_types="cpu")
def _spmm(values: torch.Tensor, rows: torch.Tensor, sorted_ids: torch.Tensor,
          offsets: torch.Tensor, num_segments: int, per_edge: bool,
          t_rows: Optional[torch.Tensor], t_sorted_ids: Optional[torch.Tensor],
          t_offsets: Optional[torch.Tensor], backward: bool) -> torch.Tensor:
    """The sum over a plan (``sorted_ids``, ``offsets``) of ``values``
    read through ``rows``; on the CPU the plain version.  ``per_edge``:
    ``rows`` is the plan's permutation.  ``t_*``: the transposed plan of
    a row-indexed sum, made once per graph (else the backward makes it).
    ``backward``: the launch is counted as a backward's."""
    return ref.segment_sum(values, rows, sorted_ids, num_segments)


@_spmm.register_kernel("cuda")
def _spmm_cuda(values, rows, sorted_ids, offsets, num_segments, per_edge,
               t_rows, t_sorted_ids, t_offsets, backward):
    plan_ = SegmentPlan(sorted_ids, rows, offsets, num_segments)
    return launch_kernel(values, plan_, rows, count="segment_spmm_backward"
                         if backward else "segment_spmm")


@_spmm.register_fake
def _(values, rows, sorted_ids, offsets, num_segments, *_):
    return values.new_empty((num_segments, values.shape[1]))


@register_flop_formula(torch.ops.repro_torch.segment_spmm)
def _spmm_flops(values_shape, rows_shape, *args, out_shape=None,
                **kwargs) -> int:
    """One fp32 add per position and column: every position, as its
    count of kept rows is data the formula does not see (PERF.md counts
    B4's bound on the kept rows)."""
    return rows_shape[0] * values_shape[1]


def _spmm_setup(ctx, inputs, output):
    values, rows, sorted_ids, _, num_segments, per_edge, t_rows, \
        t_sorted_ids, t_offsets, _ = inputs
    ctx.n_rows, ctx.per_edge = values.shape[0], per_edge
    ctx.num_segments = num_segments
    ctx.save_for_backward(rows, sorted_ids, t_rows, t_sorted_ids, t_offsets)


def _spmm_backward(ctx, grad):
    rows, sorted_ids, t_rows, t_sorted_ids, t_offsets = ctx.saved_tensors
    # what the two gradients read of the plan: edge_grad its permutation
    # (the rows of a per-edge sum) and ids, transpose its ids
    seg_plan = SegmentPlan(sorted_ids, rows, None, ctx.num_segments)
    if not ctx.needs_input_grad[0]:
        value_grad = None
    elif ctx.per_edge:
        value_grad = edge_grad(grad, seg_plan)
    else:
        if t_rows is None:
            transposed = transpose(seg_plan, rows, ctx.n_rows)
        else:
            transposed = (SegmentPlan(t_sorted_ids, None, t_offsets,
                                      ctx.n_rows), t_rows)
        value_grad = row_grad(grad, transposed)
    return (value_grad,) + (None,) * 9


_spmm.register_autograd(_spmm_backward, setup_context=_spmm_setup)


def edge_grad(grad, seg_plan: SegmentPlan):
    """Gradient of a per-edge sum with respect to its values: row ``e`` is
    ``grad[dst[e]]`` for a kept edge and 0 for a dropped one (a masked
    gather through the plan, as XLA differentiates ``segment_sum``)."""
    padded = torch.cat([grad, grad.new_zeros((1, grad.shape[1]))])
    out = torch.empty((seg_plan.order.shape[0], grad.shape[1]),
                      dtype=grad.dtype, device=grad.device)
    return out.index_copy_(0, seg_plan.order.long(), padded.index_select(
        0, seg_plan.sorted_ids.long()))


def row_grad(grad, transposed):
    """Gradient of a sum read through a row index with respect to the
    rows: B4 on the transposed plan (``transposed`` from
    :func:`transpose`), counted as a backward launch."""
    t_plan, t_rows = transposed
    return _spmm(grad.contiguous(), t_rows, t_plan.sorted_ids,
                 t_plan.offsets, t_plan.num_segments, False, None, None,
                 None, True)


def segment_sum(values, seg_plan: SegmentPlan, rows=None, transposed=None):
    """``out[s] = sum of values[rows[r]]`` over the sorted positions ``r``
    of segment ``s``, accumulated in fp32; differentiable in ``values``.

    Args:
      values: ``[R, D]`` f32 or bf16; seg_plan: from :func:`plan`;
      rows: int32 ``[E]`` row index per sorted position, default the
        plan's permutation (``values`` per edge, ``R = E``); use
        ``seg_plan.compose(src)`` to sum ``h[src]`` with ``values = h``.
      transposed: ``transpose(seg_plan, rows, R)``, made once per graph
        by a caller that sums several ``[R, D]`` tensors through the same
        rows; else the backward makes it when a gradient is needed.
    Returns:
      ``[num_segments, D]`` in the values' dtype.  CUDA tensors go to the
      kernel, CPU tensors to its plain version, forward and backward
      (``torch.ops.repro_torch.segment_spmm``).
    """
    if rows is not None and rows.shape != seg_plan.order.shape:
        raise ValueError(f"rows has shape {tuple(rows.shape)}, expected "
                         f"{tuple(seg_plan.order.shape)}")
    _check_device(values)
    t_plan, t_rows = transposed or (None, None)
    return _spmm(values, seg_plan.order if rows is None else rows,
                 seg_plan.sorted_ids, seg_plan.offsets,
                 seg_plan.num_segments, rows is None, t_rows,
                 None if t_plan is None else t_plan.sorted_ids,
                 None if t_plan is None else t_plan.offsets, False)


def scatter_sum(values, segment_ids, num_segments: int, mask=None):
    """Drop-in for ``jax.ops.segment_sum`` over 2-D values (+ mask).

    Args:
      values: ``[E, D]`` f32 or bf16; segment_ids: integer ``[E]``;
      mask: bool ``[E]`` or None.
    Returns:
      ``[num_segments, D]`` in the values' dtype: each segment's sum of its
      unmasked rows, accumulated in fp32; ids outside
      ``[0, num_segments)`` are dropped.  Builds its own :func:`plan`.
    """
    ref.check_inputs(values, segment_ids, num_segments, mask)
    return segment_sum(values, plan(segment_ids, num_segments, mask))
