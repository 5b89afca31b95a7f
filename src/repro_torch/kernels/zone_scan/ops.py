"""Wrappers of the zone-scan kernels, dispatching on device.

Two hand-written CUDA kernels, each with a ``with_ts`` variant:

* ``csrc/fused_zone_scan.cu`` — the flat single-launch scan over a
  concatenated slot stream; :func:`scan_flat` is the ``cuda`` registry
  entry's fused scan (:mod:`repro_torch.core.backends`);
* ``csrc/zone_scan.cu`` — the dense per-zone scan of a ``[Z, E]`` zone
  batch; :func:`scan_zones` is the ``cuda`` entry's per-zone scan (the
  per-bucket path and the sequential baseline).

For CUDA tensors a wrapper launches its kernel on PyTorch's current stream
(built with ``nvcc`` at first use, see :mod:`.._build`) or raises; for CPU
tensors — the tests' only device — it runs the kernel's plain version:
:func:`.ref.fused_zone_scan_torch` and
:func:`repro_torch.core.expansion.scan_zones`.  :data:`launches` counts
kernel launches per variant and nothing else.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from repro_torch.core import encoding, expansion
from repro_torch.core.backends import FUSED_BLK_DEFAULT
from repro_torch.core.expansion import ZoneResult

from . import ref

_CSRC = Path(__file__).resolve().parent / "csrc"
FUSED_SOURCE = _CSRC / "fused_zone_scan.cu"
DENSE_SOURCE = _CSRC / "zone_scan.cu"

#: kernel variants, as named in ``chip_smoke.py``'s kernel line
VARIANTS = ("fused_zone_scan_flat", "fused_zone_scan_flat_ts",
            "zone_scan_dense", "zone_scan_dense_ts")

#: kernel launches per variant since the last :func:`reset_launches` (plain
#: integers, so a run can show that its path went through each kernel)
launches = dict.fromkeys(VARIANTS, 0)
# serving sessions mine from several threads at once (a first query of an
# epoch mines outside its session's lock), so a count is bumped under a lock
_launches_lock = threading.Lock()


def _count_launch(name: str) -> None:
    with _launches_lock:
        launches[name] += 1

_P, _I = ctypes.c_void_p, ctypes.c_int
#: C function name -> (source, argtypes)
_SIGNATURES = {
    "fused_zone_scan_flat": (FUSED_SOURCE, [_P] * 9 + [_I] * 5 + [_P]),
    "fused_zone_scan_flat_occupancy": (FUSED_SOURCE, [_I, _I, _P, _P]),
    "zone_scan_dense": (DENSE_SOURCE, [_P] * 7 + [_I] * 5 + [_P]),
    "zone_scan_dense_occupancy": (DENSE_SOURCE, [_I, _I, _P, _P]),
}
_fns: dict[str, object] = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        from repro_torch.kernels import _build

        source, argtypes = _SIGNATURES[name]
        fn = getattr(_build.load(source), name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _fns[name] = fn
    return fn


def _check_cuda_inputs(arrays, device) -> None:
    for name, x in arrays.items():
        if x.device != device:
            raise ValueError(
                f"{name} is on {x.device}, expected {device} like u")
        if x.dtype != torch.int32:
            raise TypeError(f"{name} has dtype {x.dtype}, expected int32")
        if not x.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def _check_params(delta: int, l_max: int) -> int:
    limbs = encoding.n_limbs(l_max)        # raises for l_max > 14
    if l_max < 1 or delta < 1:
        raise ValueError("delta and l_max must be >= 1")
    return limbs


def _launch(name: str, device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _kernel(name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")


def _ptr(x) -> int | None:
    return None if x is None else x.data_ptr()


def launch_kernel(u, v, t, valid, zone_id, lo, hi, *, delta: int,
                  l_max: int, blk: int = FUSED_BLK_DEFAULT,
                  with_ts: bool = False):
    """Launch the flat CUDA kernel on CUDA tensors; raises on anything
    else.  Returns ``(code, length)``, plus ``ts`` with ``with_ts``."""
    if not u.is_cuda:
        raise ValueError("the fused zone-scan kernel needs CUDA tensors")
    ref.check_flat_inputs(u, v, t, valid, zone_id, lo, hi, blk=blk)
    _check_cuda_inputs(dict(u=u, v=v, t=t, valid=valid, zone_id=zone_id,
                            lo=lo, hi=hi), u.device)
    limbs = _check_params(delta, l_max)
    s_pad = u.shape[0]
    code = torch.empty((s_pad, limbs), dtype=torch.int32, device=u.device)
    length = torch.empty(s_pad, dtype=torch.int32, device=u.device)
    ts = (torch.empty((s_pad, l_max), dtype=torch.int32, device=u.device)
          if with_ts else None)
    _launch("fused_zone_scan_flat", u.device,
            u.data_ptr(), v.data_ptr(), t.data_ptr(), valid.data_ptr(),
            zone_id.data_ptr(), hi.data_ptr(), code.data_ptr(),
            length.data_ptr(), _ptr(ts), s_pad, blk, int(delta), int(l_max),
            int(with_ts))
    _count_launch("fused_zone_scan_flat_ts" if with_ts
                  else "fused_zone_scan_flat")
    return (code, length, ts) if with_ts else (code, length)


def scan_flat(u, v, t, valid, zone_id, lo, hi, *, delta: int, l_max: int,
              blk: int = FUSED_BLK_DEFAULT, with_ts: bool = False):
    """Single-launch fused scan over a concatenated flat slot stream.

    Args:
      u, v, t, valid, zone_id: int32[S] flat slot streams (see
        :func:`repro_torch.core.tzp.concat_layout`), S a multiple of
        ``blk``; ``lo, hi``: int32[S // blk] per-block sweep windows.
      with_ts: also return per-step absorption timestamps.
    Returns:
      ``(code int32[S, L], length int32[S])`` per candidate slot, plus
      ``ts int32[S, l_max]`` with ``with_ts``, on the inputs' device.
      CUDA tensors go to the kernel, CPU tensors to its plain version.
    """
    if u.is_cuda:
        return launch_kernel(u, v, t, valid, zone_id, lo, hi, delta=delta,
                             l_max=l_max, blk=blk, with_ts=with_ts)
    if u.device.type != "cpu":
        raise ValueError(f"unsupported device {u.device}")
    return ref.fused_zone_scan_torch(u, v, t, valid, zone_id, lo, hi,
                                     delta=delta, l_max=l_max, blk=blk,
                                     with_ts=with_ts)


def launch_zone_kernel(u, v, t, valid, *, delta: int, l_max: int,
                       with_ts: bool = False) -> ZoneResult:
    """Launch the dense CUDA kernel over a ``[Z, E]`` batch of CUDA
    tensors; raises on anything else.  ``valid`` may be bool or int32
    (bool is widened to the kernel's int32)."""
    if not u.is_cuda:
        raise ValueError("the dense zone-scan kernel needs CUDA tensors")
    if u.dim() != 2:
        raise ValueError(f"u has shape {tuple(u.shape)}, expected [Z, E]")
    for name, x in (("v", v), ("t", t), ("valid", valid)):
        if x.shape != u.shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                             f"expected {tuple(u.shape)}")
    if valid.dtype == torch.bool:
        valid = valid.to(torch.int32)
    _check_cuda_inputs(dict(u=u, v=v, t=t, valid=valid), u.device)
    limbs = _check_params(delta, l_max)
    z, e = u.shape
    dev = u.device
    code = torch.empty((z, e, limbs), dtype=torch.int32, device=dev)
    length = torch.empty((z, e), dtype=torch.int32, device=dev)
    ts = (torch.empty((z, e, l_max), dtype=torch.int32, device=dev)
          if with_ts else None)
    _launch("zone_scan_dense", dev,
            u.data_ptr(), v.data_ptr(), t.data_ptr(), valid.data_ptr(),
            code.data_ptr(), length.data_ptr(), _ptr(ts), z, e, int(delta),
            int(l_max), int(with_ts))
    _count_launch("zone_scan_dense_ts" if with_ts else "zone_scan_dense")
    return ZoneResult(code=code, length=length, ts=ts)


def _occupancy(name: str, l_max: int, with_ts: bool) -> tuple[int, int]:
    threads, blocks = ctypes.c_int(0), ctypes.c_int(0)
    err = _kernel(name)(int(l_max), int(with_ts), ctypes.byref(threads),
                        ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"{name} failed with CUDA error {err}")
    return threads.value, blocks.value


def flat_occupancy(l_max: int, with_ts: bool = False) -> tuple[int, int]:
    """``(threads per block, resident blocks per SM)`` of the flat
    kernel's instantiation for ``l_max`` on the current CUDA device."""
    return _occupancy("fused_zone_scan_flat_occupancy", l_max, with_ts)


def dense_occupancy(l_max: int, with_ts: bool = False) -> tuple[int, int]:
    """``(threads per block, resident blocks per SM)`` of the dense
    kernel's instantiation for ``l_max`` on the current CUDA device."""
    return _occupancy("zone_scan_dense_occupancy", l_max, with_ts)


def scan_zones(u, v, t, valid, *, delta: int, l_max: int,
               with_ts: bool = False) -> ZoneResult:
    """Dense per-zone scan of a ``[Z, E]`` zone batch (the reference
    signature of :func:`repro_torch.core.expansion.scan_zones`).

    CUDA tensors go to the kernel, CPU tensors to its plain version.
    """
    if u.is_cuda:
        return launch_zone_kernel(u, v, t, valid, delta=delta, l_max=l_max,
                                  with_ts=with_ts)
    if u.device.type != "cpu":
        raise ValueError(f"unsupported device {u.device}")
    return expansion.scan_zones(u, v, t, valid, delta=delta, l_max=l_max,
                                with_ts=with_ts)


def scan_zone(u, v, t, valid, *, delta: int, l_max: int,
              with_ts: bool = False) -> ZoneResult:
    """Dense scan of one zone's ``[E]`` edge stream (the reference
    signature of :func:`repro_torch.core.expansion.scan_zone`).

    CUDA tensors go to the kernel as a ``[1, E]`` launch, counted like
    every other; CPU tensors to its plain version.
    """
    res = scan_zones(u[None], v[None], t[None], valid[None], delta=delta,
                     l_max=l_max, with_ts=with_ts)
    return ZoneResult(*(None if x is None else x[0] for x in res))
