"""Wrapper of the embedding-bag kernel (B5), dispatching on device.

``csrc/embedding_bag.cu`` replaces the TPU kernel ``embedding_bag_pallas``
of the JAX package.  For CUDA tensors :func:`embedding_bag` launches it on
PyTorch's current stream (built with ``nvcc`` at first use, see
:mod:`.._build`) or raises; for CPU tensors — the tests' only device — it
runs the plain version :func:`.ref.embedding_bag`.  :data:`launches`
counts kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from . import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "embedding_bag.cu"

#: kernel launches since the last :func:`reset_launches`
launches = {"embedding_bag": 0}

#: table dtypes the kernel takes -> its dtype code
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_fns: dict[str, object] = {}


def reset_launches() -> None:
    launches["embedding_bag"] = 0


def _kernel():
    fn = _fns.get("embedding_bag")
    if fn is None:
        from repro_torch.kernels import _build

        fn = _build.load(SOURCE).embedding_bag
        fn.restype = ctypes.c_int
        fn.argtypes = [_P] * 4 + [_L, _I, _L, _L, _L, _I, _I, _P]
        _fns["embedding_bag"] = fn
    return fn


def _bag_rows(x, dtype):
    """``x`` as the kernel reads it: ``dtype``, k contiguous; a view with a
    bag stride stays a view."""
    x = x.to(dtype)
    return x if x.stride(1) == 1 or x.shape[1] == 1 else x.contiguous()


def launch_kernel(table, ids, weights):
    """Launch B5 on CUDA tensors; raises on anything else.

    table ``[V, D]`` f32 or bf16, ids int32 ``[B, K]``, weights ``[B, K]``
    (taken as f32) -> ``[B, D]`` in the table's dtype.
    """
    if not table.is_cuda:
        raise ValueError("the embedding-bag kernel needs CUDA tensors")
    if table.dtype not in DTYPES:
        raise TypeError(f"table has dtype {table.dtype}, expected one of "
                        f"{list(DTYPES)}")
    if ids.dtype != torch.int32:
        raise TypeError(f"ids has dtype {ids.dtype}, expected int32")
    ref.check_inputs(table, ids, weights)
    for name, x in (("ids", ids), ("weights", weights)):
        if x.device != table.device:
            raise ValueError(f"{name} is on {x.device}, expected "
                             f"{table.device} like table")
    table = table.contiguous()
    ids, weights = _bag_rows(ids, torch.int32), _bag_rows(weights,
                                                         torch.float32)
    (b, k), (v, d) = ids.shape, table.shape
    out = torch.empty((b, d), dtype=table.dtype, device=table.device)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = _kernel()(table.data_ptr(), ids.data_ptr(), weights.data_ptr(),
                        out.data_ptr(), b, k, ids.stride(0),
                        weights.stride(0), v, d, DTYPES[table.dtype], stream)
    if err != 0:
        raise RuntimeError(f"embedding_bag launch failed with CUDA error "
                           f"{err}")
    launches["embedding_bag"] += 1
    return out


def embedding_bag(table, ids, weights):
    """Weighted sum-bag lookup: table ``[V, D]``, ids ``[B, K]``, weights
    ``[B, K]`` -> ``[B, D]`` in the table's dtype.

    CUDA tensors go to the kernel, CPU tensors to its plain version.
    """
    if table.is_cuda:
        return launch_kernel(table, ids, weights)
    if table.device.type != "cpu":
        raise ValueError(f"unsupported device {table.device}")
    return ref.embedding_bag(table, ids, weights)
