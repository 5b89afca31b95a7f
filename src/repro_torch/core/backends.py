"""Pluggable zone-scan backend registry (the executor's dispatch layer).

Every Phase-1 implementation (growth-zone candidate expansion) is published
here as a :class:`BackendSpec` carrying the scan callable plus capability
metadata the executor needs to drive it correctly:

* ``grade`` — "reference" (vectorized torch, exact, any device),
  "accelerator" (hand-written CUDA kernels, exact, fast) or "oracle"
  (brute-force host walk, the ground truth tests cross-check against);
* ``host_only`` — the scan takes and returns numpy arrays on the host (the
  counterpart of the JAX package's ``jittable=False``): the executor keeps
  the scan off the device and folds its results on the device;
* ``fused_loader`` — the backend's single-launch scan over a concatenated
  flat slot stream, if it has one;
* ``supports_comine`` — the scans take ``with_ts`` and return per-step
  absorption timestamps, the co-mining fold's input;
* ``mem_model`` / ``default_zone_chunk`` / ``default_merge_cap`` — memory
  and scheduling hints for the capacity planner
  (:mod:`repro_torch.core.planner`): ``mem_model(e_cap, l_max)`` is the
  scan's per-zone device footprint in bytes.

Built-in backends, named after their counterparts in the JAX package:

* ``ref``   — the torch reference expansion (:mod:`repro_torch.core.
  expansion`); no fused scan;
* ``cuda``  — the accelerator backend (the counterpart of ``pallas``): its
  per-zone scan is the dense CUDA kernel ``kernels/zone_scan/csrc/
  zone_scan.cu``, its fused scan the flat kernel ``fused_zone_scan.cu``;
* ``torch`` — the plain fused scan (the counterpart of ``xla``): the
  reference expansion per zone plus the flat kernel's plain PyTorch
  version as its fused scan;
* ``numpy`` — the brute-force oracle walk (:mod:`repro_torch.core.
  scan_numpy`), host-only, for small inputs.

Registration is lazy: a loader imports its implementation on first use, so
importing this module builds no kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

__all__ = [
    "BackendSpec",
    "available_backends",
    "get_backend",
    "register_backend",
]


@dataclasses.dataclass
class BackendSpec:
    """One registered zone-scan implementation plus its capabilities.

    ``scan`` has the reference signature
    ``scan(u, v, t, valid, *, delta, l_max[, with_ts]) -> ZoneResult``
    over a ``[Z, E]`` zone batch (tensors on the run's device, or numpy
    arrays for a host-only backend).
    """

    name: str
    loader: Callable[[], Callable]
    grade: str = "reference"
    description: str = ""
    host_only: bool = False
    default_zone_chunk: int | None = None
    mem_model: Callable[[int, int], int] | None = None
    default_merge_cap: int | None = None
    fused_loader: Callable[[], Callable] | None = None
    supports_comine: bool = False
    _scan: Callable | None = dataclasses.field(
        default=None, repr=False, compare=False)
    _fused_scan: Callable | None = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def scan(self) -> Callable:
        """Resolve (and cache) the scan callable."""
        if self._scan is None:
            self._scan = self.loader()
        return self._scan

    @property
    def supports_fused(self) -> bool:
        """Whether this backend publishes a flat single-launch scan."""
        return self.fused_loader is not None

    @property
    def fused_scan(self) -> Callable:
        """Resolve (and cache) the fused flat-stream scan callable.

        Signature: ``fused_scan(u, v, t, valid, zone_id, lo, hi, *, delta,
        l_max, blk[, with_ts]) -> (code int32[S, L], length int32[S][,
        ts int32[S, l_max]])`` over a concatenated
        :class:`repro_torch.core.tzp.FusedZoneLayout` slot stream, where
        ``lo``/``hi`` are the layout's per-candidate-block sweep bounds.
        """
        if self.fused_loader is None:
            raise ValueError(
                f"backend {self.name!r} has no fused single-launch scan "
                f"(fused paths need a bucket-native kernel; use the "
                f"per-bucket layout path instead)")
        if self._fused_scan is None:
            self._fused_scan = self.fused_loader()
        return self._fused_scan


_REGISTRY: dict[str, BackendSpec] = {}


def register_backend(
    name: str,
    loader: Callable[[], Callable],
    *,
    grade: str = "reference",
    description: str = "",
    host_only: bool = False,
    default_zone_chunk: int | None = None,
    mem_model: Callable[[int, int], int] | None = None,
    default_merge_cap: int | None = None,
    fused_loader: Callable[[], Callable] | None = None,
    supports_comine: bool = False,
    overwrite: bool = False,
) -> BackendSpec:
    """Publish a zone-scan backend under ``name``.

    ``loader`` is a zero-arg callable returning the scan function; it runs
    at most once, on first use of ``spec.scan``.  ``fused_loader``
    (optional) resolves the backend's single-launch flat scan over a
    concatenated ragged layout — see ``BackendSpec.fused_scan``.
    """
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"backend {name!r} already registered "
                         f"(pass overwrite=True to replace)")
    spec = BackendSpec(
        name=name, loader=loader, grade=grade, description=description,
        host_only=host_only, default_zone_chunk=default_zone_chunk,
        mem_model=mem_model, default_merge_cap=default_merge_cap,
        fused_loader=fused_loader, supports_comine=supports_comine,
    )
    _REGISTRY[name] = spec
    return spec


def get_backend(name: str) -> BackendSpec:
    """Look up a backend; error lists what is available."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown backend {name!r}; available: {available_backends()}"
        ) from None


def available_backends() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


# ---------------------------------------------------------------------------
# Built-in backends.
# ---------------------------------------------------------------------------

#: Candidate-block width of the fused single-launch flat stream: the unit
#: of the host-planned ``[lo, hi)`` sweep windows.
FUSED_BLK_DEFAULT = 512


def _load_ref():
    from repro_torch.core import expansion

    return expansion.scan_zones


def _load_cuda():
    from repro_torch.kernels.zone_scan import ops

    return ops.scan_zones


def _load_cuda_fused():
    from repro_torch.kernels.zone_scan import ops

    return ops.scan_flat


def _load_torch_fused():
    from repro_torch.kernels.zone_scan import ref

    return ref.fused_zone_scan_torch


def _load_numpy():
    from repro_torch.core import scan_numpy

    return scan_numpy.scan_zones


def _ref_mem_model(e_cap: int, l_max: int) -> int:
    from repro_torch.core import planner

    return planner.ref_zone_bytes(e_cap, l_max)


def _cuda_mem_model(e_cap: int, l_max: int) -> int:
    from repro_torch.core import planner

    return planner.cuda_zone_bytes(e_cap, l_max)


register_backend(
    "ref", _load_ref,
    grade="reference",
    description="vectorized torch expansion (exact, any device)",
    mem_model=_ref_mem_model,
    supports_comine=True,
)

register_backend(
    "cuda", _load_cuda,
    grade="accelerator",
    description="hand-written CUDA kernels for Hopper (dense and flat scans)",
    mem_model=_cuda_mem_model,
    fused_loader=_load_cuda_fused,
    supports_comine=True,
)

register_backend(
    "torch", _load_ref,
    grade="reference",
    description=("plain PyTorch: reference dense scan plus the fused flat "
                 "kernel's plain version"),
    mem_model=_ref_mem_model,
    fused_loader=_load_torch_fused,
    supports_comine=True,
)

register_backend(
    "numpy", _load_numpy,
    grade="oracle",
    description="pure-NumPy brute-force walk (ground truth, small inputs)",
    host_only=True,
    mem_model=_ref_mem_model,
    default_merge_cap=4096,
    supports_comine=True,
)
