"""Roofline terms of a dry-run cell, from counts taken while its step runs.

Hardware model: one NVIDIA H100 SXM per rank (constants below, each with
its source).  The three terms of a cell are

  compute_s    = flops_per_chip / PEAK_FLOPS (or INT_PEAK for mining)
  memory_s     = bytes_per_chip / HBM_BW
  collective_s = collective_bytes_per_chip / LINK_BW

The port compiles nothing, so there is no HLO to parse: a rank's FLOPs and
collectives are counted on the tensors it would hold while its step runs
(:class:`RankCounter`, on a fake process group in the dry run), and
:func:`collective_bytes` weighs the recorded ``(kind, bytes)`` pairs with
the JAX package's ring-algorithm weights.
"""

from __future__ import annotations

import math
import weakref

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._sharding_prop import ShardingPropagator
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

# NVIDIA's H100 SXM data sheet (dense rates, without sparsity, at the
# card's 700 W limit): bf16/fp16 tensor-core peak and HBM3 bandwidth
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
# NVLink 4 on the H100 SXM: 900 GB/s per card over both directions
# (NVIDIA's data sheet), 450 GB/s each way
LINK_BW = 450e9
# the integer rate the mining bounds of PERF.md use: 132 SMs x 64 int32
# lanes x the 1.98 GHz max SM clock of the H100 SXM
INT_PEAK = 132 * 64 * 1.98e9
# device memory of one H100 SXM
HBM_BYTES = 80e9

# traffic weight per collective kind (ring algorithms, large-n limit)
_COLL_WEIGHTS = {
    "all-reduce": 2.0,          # reduce-scatter + all-gather
    "all-gather": 1.0,          # counted on the (larger) output
    "reduce-scatter": 1.0,      # counted on the (larger) input
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}


def collective_bytes(records) -> dict:
    """Per-chip collective traffic by kind from ``(kind, bytes)`` pairs:
    all-gathers give their output's bytes, reduce-scatters their input's,
    the rest their tensor's; weighted as the JAX package weighs HLO
    collectives."""
    out = {k: 0.0 for k in _COLL_WEIGHTS}
    counts = {k: 0 for k in _COLL_WEIGHTS}
    for kind, size in records:
        out[kind] += size * _COLL_WEIGHTS[kind]
        counts[kind] += 1
    return {
        "per_kind_bytes": out,
        "per_kind_counts": counts,
        "total_bytes": sum(out.values()),
    }


def _nbytes(x) -> int:
    return x.numel() * x.element_size()


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


# functional collectives -> (kind, which tensor's bytes)
_C10D = {
    "all_gather_into_tensor": ("all-gather", "out"),
    "all_gather_into_tensor_coalesced": ("all-gather", "out"),
    "reduce_scatter_tensor": ("reduce-scatter", "in"),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", "in"),
    "all_reduce": ("all-reduce", "in"),
    "all_reduce_coalesced": ("all-reduce", "in"),
    "all_to_all_single": ("all-to-all", "in"),
    "broadcast": ("collective-permute", "in"),
}


class RankCounter(TorchDispatchMode):
    """Counts, over what runs inside it, one rank's work on its own
    tensors (a DTensor operation is let through to DTensor, which runs it
    on the shards, and those ops are counted):

    * ``flops``: ``torch.utils.flop_counter``'s formulas (the matmul
      family, FlopCounterMode's count, and the formulas the B4 and B5
      custom ops register);
    * ``collectives``: ``(kind, bytes)`` of each functional collective;
    * ``op_bytes``: the bytes each op reads and writes (an upper bound on
      the memory traffic, as HLO's "bytes accessed" is);
    * with ``track_memory``, ``peak_bytes``: the most bytes of storage
      live at once, counting the tensors given to :meth:`hold` and every
      op output, each storage once, until its last tensor is freed.

    DTensor derives an output's global shape by running the op on fake
    tensors of the global shapes; those runs are no rank's work and are
    not counted (the counter wraps the sharding propagator's
    ``_propagate_tensor_meta_non_cached`` while it is on).
    """

    def __init__(self, track_memory: bool = False):
        super().__init__()
        self.flops = 0
        self.collectives: list[tuple[str, int]] = []
        self.op_bytes = 0
        self.track_memory = track_memory
        self.live_bytes = self.peak_bytes = 0
        self._seen = WeakIdKeyDictionary()
        self._users: dict[int, int] = {}
        self._held: list = []
        self._paused = 0
        self._meta = None

    def __enter__(self):
        self._meta = meta = \
            ShardingPropagator._propagate_tensor_meta_non_cached

        def paused(prop, *args, **kwargs):
            self._paused += 1
            try:
                return meta(prop, *args, **kwargs)
            finally:
                self._paused -= 1

        ShardingPropagator._propagate_tensor_meta_non_cached = paused
        return super().__enter__()

    def __exit__(self, *exc):
        ShardingPropagator._propagate_tensor_meta_non_cached = self._meta
        return super().__exit__(*exc)

    def hold(self, *tensors) -> None:
        """Count ``tensors``' storages as live (a step's arguments; kept
        alive by the counter)."""
        self._held.extend(tensors)
        for t in tensors:
            self._track(t)

    def _release(self, key: int, nbytes: int) -> None:
        self._users[key] -= 1
        if not self._users[key]:
            del self._users[key]
            self.live_bytes -= nbytes

    def _track(self, t) -> None:
        if t in self._seen:
            return
        self._seen[t] = True
        st = t.untyped_storage()
        key, nbytes = st._cdata, st.nbytes()
        if key not in self._users:
            self._users[key] = 0
            self.live_bytes += nbytes
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        self._users[key] += 1
        weakref.finalize(t, self._release, key, nbytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._paused or isinstance(func, torch._ops.HigherOrderOperator):
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        ins = list(_tensors((args, kwargs)))
        outs = list(_tensors(out))
        self.op_bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        if (func.namespace == "_c10d_functional"
                and packet.__name__ in _C10D):
            kind, which = _C10D[packet.__name__]
            self.collectives.append(
                (kind, sum(map(_nbytes, outs if which == "out" else
                               ins[:1]))))
        if self.track_memory:
            for t in outs:
                self._track(t)
        return out


def roofline(record: dict) -> dict:
    """record: flops_per_chip, bytes_per_chip, collective_bytes_per_chip,
    n_chips, model_flops (global), optional peak_flops override (integer
    workloads like the mining sweep use INT_PEAK)."""
    peak = record.get("peak_flops", PEAK_FLOPS)
    compute_s = record["flops_per_chip"] / peak
    memory_s = record["bytes_per_chip"] / HBM_BW
    collective_s = record["collective_bytes_per_chip"] / LINK_BW
    dominant = max(
        ("compute", compute_s), ("memory", memory_s),
        ("collective", collective_s), key=lambda kv: kv[1],
    )[0]
    flops_global = record["flops_per_chip"] * record["n_chips"]
    useful = record["model_flops"] / flops_global if flops_global else 0.0
    bound_s = max(compute_s, memory_s, collective_s)
    # roofline fraction: useful model flops vs what the chips could do in
    # the bound time
    frac = (
        record["model_flops"] / (record["n_chips"] * peak * bound_s)
        if bound_s else 0.0
    )
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": dominant,
        "useful_flops_ratio": useful,
        "roofline_fraction": frac,
    }


def fits(peak_bytes: float) -> bool:
    """Whether a rank's peak fits one card's memory."""
    return math.isfinite(peak_bytes) and peak_bytes <= HBM_BYTES
