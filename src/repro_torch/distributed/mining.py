"""Distributed PTMT: zones sharded over a ``DeviceMesh`` (the paper's
thread pool).

SPMD over processes: every rank of the mesh calls the same step on the
same host-built zone batch; each rank scans and aggregates its own block
of the zones — the contiguous block whose index is the rank's row-major
coordinate over ``axes``, the block ``P(axes)`` gives a device of the JAX
package's mesh — and the merged count table comes back replicated on
every rank.  Per-rank scan + signed aggregation is delegated to
:meth:`repro_torch.core.executor.MiningExecutor.scan_aggregate_partial`
(on ``cuda``, the dense kernel once per chunk of the rank's zones); this
module owns only the collective merge.  Phase-2 aggregation becomes a
**multi-level merge**:

  1. every rank folds its own zones into a partial count table — when the
     executor is chunked this is the hierarchical bounded-carry fold;
  2. only the first ``out_cap`` rows (a configurable unique-code budget)
     are all-gathered and merged, shrinking the collective payload from
     O(zones_local * e_cap) to O(out_cap) per rank.

Overflow of either budget — the collective ``out_cap`` or the
hierarchical ``merge_cap`` carry — is detected and surfaced (a summed
flag) rather than silently truncated.  The mesh's dimension names play
the JAX mesh's axis names; nothing is compiled.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.core import aggregation
from repro_torch.core.aggregation import CodeCounts
from repro_torch.core.executor import MiningExecutor, merge_partial_counts

from .collectives import all_gather_tiled, psum

def _dims(mesh, axes) -> list[int]:
    names = list(mesh.mesh_dim_names or ())
    missing = [a for a in axes if a not in names]
    if missing:
        raise ValueError(f"axes {missing} are not dimensions of the mesh "
                         f"{tuple(names)}")
    return [names.index(a) for a in axes]


def n_shards(mesh, axes) -> int:
    """The number of zone blocks: the product of the sizes of ``axes``."""
    return math.prod(mesh.shape[d] for d in _dims(mesh, axes))


def shard_index(mesh, axes) -> int:
    """This rank's row-major coordinate over ``axes``."""
    coord = mesh.get_coordinate()
    idx = 0
    for d in _dims(mesh, axes):
        idx = idx * mesh.shape[d] + coord[d]
    return idx


def axes_group(mesh, axes):
    """The process group of the ranks that share this rank's coordinates
    outside ``axes``, ordered row-major over ``axes`` (one mesh dimension:
    ``mesh.get_group(axis)``).  Every rank of the mesh must call it, the
    first time, since each such group is made by all of them."""
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    # kept on the mesh object: an equal mesh of a later world (after the
    # process group was destroyed) must make its own groups
    groups = mesh.__dict__.setdefault("_ptmt_axes_groups", {})
    group = groups.get(tuple(axes))
    if group is None:
        dims = _dims(mesh, axes)
        rest = [d for d in range(mesh.ndim) if d not in dims]
        rows = mesh.mesh.permute(*rest, *dims).reshape(
            -1, n_shards(mesh, axes)).tolist()
        me = dist.get_rank()
        for row in rows:
            made = dist.new_group(row)
            if me in row:
                group = made
        groups[tuple(axes)] = group
    return group


def _as_executor(
    executor: MiningExecutor | None,
    *,
    mesh,
    delta: int | None,
    l_max: int | None,
    backend: str,
    zone_chunk: int | None,
    agg: str = "auto",
    merge_cap: int | None = None,
    config=None,
) -> MiningExecutor:
    device = torch.device(mesh.device_type)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    if executor is None and config is not None:
        executor = MiningExecutor.from_config(config, device=device)
    if executor is None:
        if delta is None or l_max is None:
            raise ValueError(
                "pass an executor, a MiningConfig, or delta+l_max")
        executor = MiningExecutor(delta=delta, l_max=l_max, backend=backend,
                                  zone_chunk=zone_chunk, agg=agg,
                                  merge_cap=merge_cap, device=device)
    if executor.spec.host_only:
        raise ValueError(
            f"backend {executor.backend!r} is host-only and cannot be "
            f"sharded over a mesh; use a backend that scans on the device"
        )
    if executor.device.type != mesh.device_type:
        raise ValueError(
            f"the executor runs on {executor.device.type}, the mesh on "
            f"{mesh.device_type}; build them for one device type")
    return executor


def make_mine_fn(
    mesh,
    axes: tuple[str, ...],
    *,
    executor: MiningExecutor | None = None,
    config=None,
    delta: int | None = None,
    l_max: int | None = None,
    backend: str = "ref",
    zone_chunk: int = 0,
    agg: str = "auto",
    merge_cap: int | None = None,
    out_cap: int = 65536,
    merge_mode: str = "flat",
):
    """Build the SPMD mining step for a zone batch.

    Returns ``fn(u, v, t, valid, signs) -> (CodeCounts, overflow)``: every
    rank passes the whole ``[Z, E]`` batch (host arrays or tensors) and
    mines its block of the zone axis; the result is replicated.  Pass a
    configured :class:`MiningExecutor` (on the mesh's device type), a
    :class:`repro_torch.core.config.MiningConfig`, or delta/l_max/backend/
    zone_chunk (+ agg/merge_cap) to build one on the mesh's device.  With
    a chunked executor the per-rank aggregation is the hierarchical
    bounded-carry fold; its merge-cap spills are folded into the returned
    overflow flag.

    merge_mode:
      "flat"         — one all-gather over the group spanning every axis,
                       then a single merge;
      "hierarchical" — gather+merge one mesh axis at a time (innermost
                       first, through ``mesh.get_group(axis)``).
                       Duplicate codes collapse at each stage, so per-rank
                       traffic drops from O(n_ranks * out_cap) to
                       O(sum(axis sizes) * out_cap).
    """
    if merge_mode not in ("flat", "hierarchical"):
        raise ValueError(f"unknown merge_mode {merge_mode!r}")
    axes = tuple(axes)
    executor = _as_executor(executor, mesh=mesh, delta=delta, l_max=l_max,
                            backend=backend, zone_chunk=zone_chunk,
                            agg=agg, merge_cap=merge_cap, config=config)
    shards = n_shards(mesh, axes)
    index = shard_index(mesh, axes)
    flat_group = axes_group(mesh, axes)
    dev = executor.device

    def _compact(counts_: CodeCounts, cap: int):
        send_codes = torch.where(
            counts_.unique_mask[:cap, None], counts_.codes[:cap], 0)
        send_counts = torch.where(
            counts_.unique_mask[:cap], counts_.counts[:cap], 0)
        overflow = (counts_.unique_mask.sum() > cap).to(torch.int32)
        return send_codes, send_counts, overflow

    def _block(x):
        z = x.shape[0]
        if z % shards:
            raise ValueError(f"zone count {z} does not divide into "
                             f"{shards} shards; build the layout with "
                             f"n_shards={shards}")
        zl = z // shards
        return torch.as_tensor(x[index * zl:(index + 1) * zl], device=dev)

    def step(u, v, t, valid, signs):
        local, merge_spill = executor.scan_aggregate_partial(
            *(_block(x) for x in (u, v, t, valid, signs)))
        cap = min(out_cap, local.counts.shape[0])
        overflow = merge_spill
        if merge_mode == "hierarchical":
            merged = local
            for axis in reversed(axes):      # innermost (fastest) first
                send_codes, send_counts, ovf = _compact(merged, cap)
                overflow = overflow + ovf
                group = mesh.get_group(axis)
                merged = aggregation.count_codes(
                    all_gather_tiled(send_codes, group),
                    all_gather_tiled(send_counts, group))
        else:
            send_codes, send_counts, ovf = _compact(local, cap)
            overflow = overflow + ovf
            merged = aggregation.count_codes(
                all_gather_tiled(send_codes, flat_group),
                all_gather_tiled(send_counts, flat_group))
        overflow = psum(overflow, flat_group)
        return merged, overflow

    return step


def make_mine_step(mesh, axes, **kw):
    """The step of :func:`make_mine_fn`: nothing is compiled, so it is the
    same callable."""
    return make_mine_fn(mesh, axes, **kw)


def run_mine_fn(fn, batch, *, out_cap: int = 65536) -> CodeCounts:
    """Drive a built mining step over a host :class:`ZoneBatch`.

    The single copy of the overflow-surfacing policy: :func:`mine_on_mesh`
    (one-shot) and :meth:`repro_torch.core.engine.PTMTEngine.sharded`
    (cached step) both call it.  A positive summed overflow flag —
    collective ``out_cap`` exceeded or a hierarchical ``merge_cap`` carry
    spill — raises instead of silently truncating.
    """
    counts, overflow = fn(batch.u, batch.v, batch.t, batch.valid,
                          batch.sign)
    if int(overflow) > 0:
        raise RuntimeError(
            f"unique-code budget overflow on the mesh (psum flag "
            f"{int(overflow)}): either a device exceeded out_cap="
            f"{out_cap} at the collective merge or its hierarchical "
            f"merge_cap carry spilled; re-run with a larger out_cap / "
            f"merge_cap"
        )
    return counts


def run_mine_layout(fn, layout, *, out_cap: int = 65536,
                    merge_cap: int | None = None,
                    on_bucket=None) -> CodeCounts:
    """Drive a built SPMD step over every bucket of a layout and merge.

    Each bucket runs through :func:`run_mine_fn`, then the replicated
    partial tables fold through the bounded signed carry.
    ``on_bucket(bucket)`` is invoked after each bucket's run.  Callers
    enforce the overflow policy
    (``MiningExecutor.check_layout_overflow``) first.
    """
    parts = []
    for bucket in layout.buckets:
        parts.append(run_mine_fn(fn, bucket, out_cap=out_cap))
        if on_bucket is not None:
            on_bucket(bucket)
    return merge_partial_counts(parts, merge_cap=merge_cap,
                                warn_label="sharded bucket")


def mine_layout_on_mesh(
    layout,
    mesh,
    axes: tuple[str, ...],
    *,
    executor: MiningExecutor | None = None,
    config=None,
    delta: int | None = None,
    l_max: int | None = None,
    backend: str = "ref",
    zone_chunk: int | None = None,
    agg: str = "auto",
    merge_cap: int | None = None,
    out_cap: int = 65536,
    merge_mode: str = "flat",
    allow_overflow: bool = False,
) -> CodeCounts:
    """Distributed discovery over a host-built ``ZoneBatchLayout``.

    Sharding is **per bucket**: each size bucket's zone axis is sharded
    over the mesh independently (its zones were dealt round-robin across
    the shard lanes at build time, so the static load balance holds
    within every capacity class), one step serves every bucket, and the
    replicated per-bucket count tables fold through the bounded signed
    carry (:func:`repro_torch.core.executor.merge_partial_counts`).  Build
    the layout with ``n_shards`` = the product of the axes' sizes so
    every bucket's zone count divides the shard count.  Layouts that
    dropped edges raise :class:`~repro_torch.core.executor.
    ZoneOverflowError` (the policy of the local ``run_layout``) unless
    ``allow_overflow=True``.
    """
    ex = _as_executor(executor, mesh=mesh, delta=delta, l_max=l_max,
                      backend=backend, zone_chunk=zone_chunk, agg=agg,
                      merge_cap=merge_cap, config=config)
    MiningExecutor.check_layout_overflow(layout,
                                         allow_overflow=allow_overflow)
    fn = make_mine_step(mesh, axes, executor=ex, out_cap=out_cap,
                        merge_mode=merge_mode)
    return run_mine_layout(fn, layout, out_cap=out_cap,
                           merge_cap=ex.merge_cap)


def mine_on_mesh(
    batch,
    mesh,
    axes: tuple[str, ...],
    *,
    executor: MiningExecutor | None = None,
    config=None,
    delta: int | None = None,
    l_max: int | None = None,
    backend: str = "ref",
    zone_chunk: int | None = None,
    agg: str = "auto",
    merge_cap: int | None = None,
    out_cap: int = 65536,
) -> CodeCounts:
    """Run distributed discovery over a host-built :class:`ZoneBatch`.

    One-shot: builds the step per call.  For repeated sharded runs use
    :meth:`repro_torch.core.engine.PTMTEngine.sharded`, which caches the
    step per mesh geometry.
    """
    fn = make_mine_step(
        mesh, axes, executor=executor, config=config, delta=delta,
        l_max=l_max, backend=backend, zone_chunk=zone_chunk or 0, agg=agg,
        merge_cap=merge_cap, out_cap=out_cap,
    )
    return run_mine_fn(fn, batch, out_cap=out_cap)


def input_specs(n_zones: int, e_cap: int) -> dict:
    """``(shape, dtype)`` of each input of the mining step."""
    zs = ((n_zones, e_cap), torch.int32)
    return dict(u=zs, v=zs, t=zs, valid=((n_zones, e_cap), torch.bool),
                signs=((n_zones,), torch.int32))
