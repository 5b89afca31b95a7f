"""Pluggable zone-scan backend registry (the executor's dispatch layer).

Every Phase-1 implementation (growth-zone candidate expansion) is published
here as a :class:`BackendSpec` carrying the scan callable plus capability
metadata the executor needs to drive it correctly:

* ``grade`` — "reference" (vectorized torch, exact, any device) or
  "accelerator" (a hand-written CUDA kernel, exact, fast);
* ``fused_loader`` — the backend's single-launch scan over a concatenated
  flat slot stream, if it has one;
* ``default_zone_chunk`` / ``default_merge_cap`` — scheduling and memory
  hints.

Built-in backends, named after their counterparts in the JAX package:

* ``ref``   — the torch reference expansion (:mod:`repro_torch.core.
  expansion`); no fused scan;
* ``cuda``  — the accelerator backend (the counterpart of ``pallas``): its
  fused scan is the CUDA kernel ``kernels/zone_scan/csrc/
  fused_zone_scan.cu``.  Its per-zone dense scan is not ported yet and
  raises;
* ``torch`` — the plain fused scan (the counterpart of ``xla``): the
  reference expansion per zone plus the kernel's plain PyTorch version as
  its fused scan.

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
    ``scan(u, v, t, valid, *, delta, l_max) -> ZoneResult`` over a
    ``[Z, E]`` zone batch of tensors.
    """

    name: str
    loader: Callable[[], Callable]
    grade: str = "reference"
    description: str = ""
    default_zone_chunk: int | None = None
    default_merge_cap: int | None = None
    fused_loader: Callable[[], Callable] | None = None
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
        l_max, blk) -> (code int32[S, L], length int32[S])`` over a
        concatenated :class:`repro_torch.core.tzp.FusedZoneLayout` slot
        stream, where ``lo``/``hi`` are the layout's per-candidate-block
        sweep bounds.
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
    default_zone_chunk: int | None = None,
    default_merge_cap: int | None = None,
    fused_loader: Callable[[], Callable] | None = None,
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
        default_zone_chunk=default_zone_chunk,
        default_merge_cap=default_merge_cap, fused_loader=fused_loader,
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
    raise NotImplementedError(
        "the cuda backend's per-zone dense scan (TPU kernel B3, "
        "zone_scan_pallas) is not ported yet: ROADMAP slice 2.  Use "
        "backend='ref' for per-zone scans.")


def _load_cuda_fused():
    from repro_torch.kernels.zone_scan import ops

    return ops.scan_flat


def _load_torch_fused():
    from repro_torch.kernels.zone_scan import ref

    return ref.fused_zone_scan_torch


register_backend(
    "ref", _load_ref,
    grade="reference",
    description="vectorized torch expansion (exact, any device)",
)

register_backend(
    "cuda", _load_cuda,
    grade="accelerator",
    description="hand-written CUDA kernel for Hopper (fused flat scan)",
    fused_loader=_load_cuda_fused,
)

register_backend(
    "torch", _load_ref,
    grade="reference",
    description=("plain PyTorch: reference dense scan plus the fused flat "
                 "kernel's plain version"),
    fused_loader=_load_torch_fused,
)
