"""Wrapper of the fused flat zone-scan kernel, dispatching on device.

``scan_flat`` is the ``cuda`` registry entry's fused scan
(:mod:`repro_torch.core.backends`).  For CUDA tensors it launches the
hand-written kernel ``csrc/fused_zone_scan.cu`` on PyTorch's current
stream (built with ``nvcc`` at first use, see :mod:`.._build`) or raises;
for CPU tensors — the tests' only device — it runs the kernel's plain
version :func:`.ref.fused_zone_scan_torch`.  :data:`launches` counts
kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.core import encoding
from repro_torch.core.backends import FUSED_BLK_DEFAULT

from . import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "fused_zone_scan.cu"

#: kernel launches since the last reset (a plain integer, so a run can
#: show that its main path went through the kernel)
launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from repro_torch.kernels import _build

        fn = _build.load(SOURCE).fused_zone_scan_flat
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 8
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        _fn = fn
    return _fn


def _check_cuda_inputs(arrays, device) -> None:
    for name, x in arrays.items():
        if x.device != device:
            raise ValueError(
                f"{name} is on {x.device}, expected {device} like u")
        if x.dtype != torch.int32:
            raise TypeError(f"{name} has dtype {x.dtype}, expected int32")
        if not x.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def launch_kernel(u, v, t, valid, zone_id, lo, hi, *, delta: int,
                  l_max: int, blk: int = FUSED_BLK_DEFAULT):
    """Launch the CUDA kernel on CUDA tensors; raises on anything else."""
    global launches
    if not u.is_cuda:
        raise ValueError("the fused zone-scan kernel needs CUDA tensors")
    ref.check_flat_inputs(u, v, t, valid, zone_id, lo, hi, blk=blk)
    _check_cuda_inputs(dict(u=u, v=v, t=t, valid=valid, zone_id=zone_id,
                            lo=lo, hi=hi), u.device)
    limbs = encoding.n_limbs(l_max)        # raises for l_max > 14
    if l_max < 1 or delta < 1:
        raise ValueError("delta and l_max must be >= 1")
    s_pad = u.shape[0]
    code = torch.empty((s_pad, limbs), dtype=torch.int32, device=u.device)
    length = torch.empty(s_pad, dtype=torch.int32, device=u.device)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = _kernel()(
            u.data_ptr(), v.data_ptr(), t.data_ptr(), valid.data_ptr(),
            zone_id.data_ptr(), hi.data_ptr(), code.data_ptr(),
            length.data_ptr(), s_pad, blk, int(delta), int(l_max), stream)
    if err != 0:
        raise RuntimeError(
            f"fused_zone_scan_flat launch failed with CUDA error {err}")
    launches += 1
    return code, length


def scan_flat(u, v, t, valid, zone_id, lo, hi, *, delta: int, l_max: int,
              blk: int = FUSED_BLK_DEFAULT):
    """Single-launch fused scan over a concatenated flat slot stream.

    Args:
      u, v, t, valid, zone_id: int32[S] flat slot streams (see
        :func:`repro_torch.core.tzp.concat_layout`), S a multiple of
        ``blk``; ``lo, hi``: int32[S // blk] per-block sweep windows.
    Returns:
      ``(code int32[S, L], length int32[S])`` per candidate slot, on the
      inputs' device.  CUDA tensors go to the kernel, CPU tensors to its
      plain version.
    """
    if u.is_cuda:
        return launch_kernel(u, v, t, valid, zone_id, lo, hi, delta=delta,
                             l_max=l_max, blk=blk)
    if u.device.type != "cpu":
        raise ValueError(f"unsupported device {u.device}")
    return ref.fused_zone_scan_torch(u, v, t, valid, zone_id, lo, hi,
                                     delta=delta, l_max=l_max, blk=blk)
