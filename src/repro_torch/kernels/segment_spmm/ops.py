"""Wrapper of the segment scatter-sum kernel (B4), dispatching on device.

``csrc/segment_spmm.cu`` replaces the TPU kernel
``scatter_sum_sorted_pallas`` of the JAX package.  Like the JAX wrapper,
:func:`scatter_sum` gives every masked or out-of-range row the sentinel id
``num_segments``, takes a stable argsort by id and launches the kernel over
the sorted rows.  It neither zeroes the masked rows nor materialises a
sorted copy of the values: the kernel reads each row through the
permutation and never reads a sentinel row.

For CUDA tensors the wrapper launches the kernel on PyTorch's current
stream (built with ``nvcc`` at first use, see :mod:`.._build`) or raises;
for CPU tensors — the tests' only device — it runs the plain version
:func:`.ref.scatter_sum`.  :data:`launches` counts kernel launches and
nothing else.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from . import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "segment_spmm.cu"

#: kernel launches since the last :func:`reset_launches`
launches = {"segment_spmm": 0}

#: value dtypes the kernel takes -> its dtype code
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_fns: dict[str, object] = {}


def reset_launches() -> None:
    launches["segment_spmm"] = 0


def _kernel():
    fn = _fns.get("segment_spmm")
    if fn is None:
        from repro_torch.kernels import _build

        fn = _build.load(SOURCE).segment_spmm
        fn.restype = ctypes.c_int
        fn.argtypes = [_P] * 5 + [_L, _I, _I, _I, _P]
        _fns["segment_spmm"] = fn
    return fn


def sort_rows(segment_ids, num_segments: int, mask=None):
    """``(sorted_ids int32[E], order int64[E])``: the ids with dropped rows
    at the sentinel ``num_segments``, stably sorted, and the permutation
    that sorts them."""
    ids = ref.kept_ids(segment_ids.to(torch.int32), num_segments, mask)
    return torch.sort(ids, stable=True)


def launch_kernel(values, sorted_ids, order, num_segments: int):
    """Launch B4 on CUDA tensors; raises on anything else.

    Row ``order[r]`` of ``values [E, D]`` (f32 or bf16) is summed into
    segment ``sorted_ids[r]``; ``sorted_ids`` (int32) must be ascending
    and ``order`` a permutation of the rows, as :func:`sort_rows` gives
    them.  Rows with an id outside ``[0, num_segments)``, such as the
    sentinel ``num_segments``, are dropped.  Returns ``[num_segments, D]``
    in the values' dtype.
    """
    if not values.is_cuda:
        raise ValueError("the segment scatter-sum kernel needs CUDA tensors")
    if values.dtype not in DTYPES:
        raise TypeError(f"values has dtype {values.dtype}, expected one of "
                        f"{list(DTYPES)}")
    ref.check_inputs(values, sorted_ids, num_segments)
    if order.shape != sorted_ids.shape:
        raise ValueError(f"order has shape {tuple(order.shape)}, expected "
                         f"{tuple(sorted_ids.shape)}")
    for name, x, dtype in (("sorted_ids", sorted_ids, torch.int32),
                           ("order", order, torch.int64)):
        if x.device != values.device:
            raise ValueError(f"{name} is on {x.device}, expected "
                             f"{values.device} like values")
        if x.dtype != dtype:
            raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    values, sorted_ids, order = (x.contiguous()
                                 for x in (values, sorted_ids, order))
    e, d = values.shape
    dev = values.device
    offsets = torch.empty(num_segments + 1, dtype=torch.int64, device=dev)
    out = torch.empty((num_segments, d), dtype=values.dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel()(values.data_ptr(), sorted_ids.data_ptr(),
                        order.data_ptr(), offsets.data_ptr(),
                        out.data_ptr(), e, d, num_segments,
                        DTYPES[values.dtype], stream)
    if err != 0:
        raise RuntimeError(f"segment_spmm launch failed with CUDA error "
                           f"{err}")
    launches["segment_spmm"] += 1
    return out


def scatter_sum(values, segment_ids, num_segments: int, mask=None):
    """Drop-in for ``jax.ops.segment_sum`` over 2-D values (+ mask).

    Args:
      values: ``[E, D]`` f32 or bf16; segment_ids: integer ``[E]``;
      mask: bool ``[E]`` or None.
    Returns:
      ``[num_segments, D]`` in the values' dtype: each segment's sum of its
      unmasked rows, accumulated in fp32; ids outside
      ``[0, num_segments)`` are dropped.  CUDA tensors go to the kernel,
      CPU tensors to its plain version.
    """
    ref.check_inputs(values, segment_ids, num_segments, mask)
    if values.is_cuda:
        sorted_ids, order = sort_rows(segment_ids, num_segments, mask)
        return launch_kernel(values, sorted_ids, order, num_segments)
    if values.device.type != "cpu":
        raise ValueError(f"unsupported device {values.device}")
    return ref.scatter_sum(values, segment_ids, num_segments, mask)
