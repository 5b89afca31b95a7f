"""Logical-axis sharding resolver on ``DeviceMesh`` and DTensor.

Models annotate tensors with *logical* partition specs: one entry per
dimension, each a mesh-axis name, a tuple of names or ``None``.
:func:`resolve` adapts a spec to a concrete mesh exactly as the JAX
package's resolver does: axes missing from the mesh, or already used by
an earlier dimension, are dropped, and an axis group shrinks from its end
until it divides the dimension (8 KV heads on a 16-way ``model`` axis:
replicated; batch 1 in ``long_500k``: replicated, which frees ``data``
for the KV cache's sequence).  So DTensor never sees an uneven shard.

:func:`placements` turns a resolved spec into DTensor placements: each
mesh dimension that a tensor dimension uses gets ``Shard(dim)``, the rest
``Replicate()``.  A dimension split over an axis group (``("pod",
"data")``) is sharded on each of its mesh dimensions, major axis first,
which is DTensor's default shard order when the group follows the mesh's
order; a group in another order is refused.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch.distributed.tensor import DTensor, Partial, Placement, \
    Replicate, Shard

BATCH = ("pod", "data")     # batch dim: data parallel over pods and data
FSDP = "data"               # parameter shards gathered on use
MODEL = "model"             # tensor-parallel axis
SEQ = ("data", "model")     # sequence sharding for giant KV caches
EDGE = ("pod", "data", "model")  # GNN edge streams: the whole mesh


def mesh_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` (the JAX ``mesh.shape``)."""
    return dict(zip(mesh.mesh_dim_names or (), mesh.shape, strict=True))


def _axes_in_mesh(entry, sizes) -> tuple[str, ...]:
    if entry is None:
        return ()
    if isinstance(entry, str):
        entry = (entry,)
    return tuple(a for a in entry if a in sizes)


def resolve(spec, shape, mesh) -> tuple:
    """Adapt a logical ``spec`` to ``mesh`` given the concrete ``shape``:
    per dimension one axis name, a tuple of names, or ``None`` (the JAX
    ``PartitionSpec``'s entries)."""
    sizes = mesh_sizes(mesh)
    out = []
    used: set[str] = set()
    for dim, entry in enumerate(spec):
        axes = [a for a in _axes_in_mesh(entry, sizes) if a not in used]
        # shrink the axis group until it divides the dimension
        while axes and shape[dim] % math.prod(sizes[a] for a in axes):
            axes = axes[:-1]
        if axes:
            used.update(axes)
            out.append(axes[0] if len(axes) == 1 else tuple(axes))
        else:
            out.append(None)
    return tuple(out)


def placements(resolved, mesh) -> tuple:
    """DTensor placements of a resolved spec on ``mesh``."""
    names = list(mesh.mesh_dim_names or ())
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(resolved):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(
                f"axis group {axes} of dimension {dim} is not in the "
                f"mesh's order {tuple(names)}: its shards cannot be laid "
                "out without reordering them")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A tensor's layout on a mesh: the resolved spec and its placements
    (the JAX ``NamedSharding``)."""

    mesh: object
    spec: tuple
    placements: tuple


def named_sharding(mesh, spec, shape) -> NamedSharding:
    resolved = resolve(spec, shape, mesh)
    return NamedSharding(mesh, resolved, placements(resolved, mesh))


def on_mesh(mesh) -> bool:
    """Whether ``mesh`` holds more than one device (else every tensor
    stays a plain tensor)."""
    return mesh is not None and mesh.size() > 1


def constrain(x, mesh, *spec):
    """``x`` laid out by the logical ``spec`` on ``mesh``: the identity
    without a mesh or on a one-device mesh; on a larger mesh ``x`` must be
    a DTensor and is redistributed to the resolved placements, and so is
    its gradient (JAX's ``with_sharding_constraint`` transposes to the
    same constraint on the cotangent; DTensor alone would pass a partial
    gradient on, and the matmul before the site would then run at full
    width on every rank)."""
    if not on_mesh(mesh):
        return x
    if not isinstance(x, DTensor):
        raise TypeError(
            f"constrain to {spec} on a {mesh.size()}-device mesh needs a "
            f"DTensor, got a plain {type(x).__name__}")
    return _Constrain.apply(x, placements(resolve(spec, x.shape, mesh),
                                          mesh))


class _Constrain(torch.autograd.Function):
    """DTensor ``x`` redistributed to ``want``, its gradient too."""

    @staticmethod
    def forward(ctx, x, want):
        ctx.want = want
        if tuple(x.placements) == want:
            return x.view_as(x)
        return x.redistribute(x.device_mesh, want)

    @staticmethod
    def backward(ctx, grad):
        if tuple(grad.placements) != ctx.want:
            grad = grad.redistribute(grad.device_mesh, ctx.want)
        return grad, None


def replicate(x, mesh):
    """A tensor the model makes itself (a RoPE table, a zero, an index
    range) as a replicated DTensor on ``mesh``; unchanged off a mesh."""
    if not on_mesh(mesh):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _chunk(mesh, placements, dim: int, size: int) -> tuple[int, int]:
    """``(offset, size)`` of this rank's chunk of a dimension of ``size``
    along ``dim`` under ``placements`` (DTensor's chunking, mesh dimension
    by mesh dimension; host arithmetic, so it holds for fake tensors)."""
    coord = mesh.get_coordinate()
    offset = 0
    for i, p in enumerate(placements):
        if isinstance(p, Shard) and p.dim == dim:
            full = -(-size // mesh.size(i))
            start = min(full * coord[i], size)
            size = max(min(full, size - start), 0)
            offset += start
    return offset, size


def shard_offset(x, dim: int) -> int:
    """Where this rank's shard of DTensor ``x`` starts along ``dim``."""
    return _chunk(x.device_mesh, x.placements, dim, x.shape[dim])[0]


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose gradient is made contiguous."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def local_call(fn, out_placements, in_placements, *args,
               grad_placements=None):
    """``fn`` on this rank's shards of ``args``, after each DTensor
    argument is redistributed to its entry of ``in_placements`` (``None``
    for an argument that is not a tensor); the outputs are DTensors of
    ``out_placements`` on the arguments' mesh (``torch``'s
    ``local_map``, differentiable).  ``out_placements`` is one output's
    placements, or a tuple of them for a tuple of outputs.  An input
    replicated over ranks that use different parts of it gets a partial
    gradient: ``grad_placements`` names it (default: ``in_placements``)."""
    from torch.distributed.tensor.experimental import local_map

    mesh = next(a.device_mesh for a in args if isinstance(a, DTensor))

    def dense(*local):
        # DTensor takes a shard's strides for its global tensor's, so a
        # shard (or its gradient) must be contiguous
        out = fn(*(_ContiguousGrad.apply(a) if torch.is_tensor(a)
                   and a.requires_grad else a for a in local))
        if isinstance(out, tuple):
            return tuple(o.contiguous() for o in out)
        return out.contiguous()

    if isinstance(out_placements[0], Placement):
        out = list(out_placements)
    else:
        out = tuple(list(p) for p in out_placements)
    ins = tuple(None if p is None else list(p) for p in in_placements)
    grads = ins if grad_placements is None else tuple(
        None if p is None else list(p) for p in grad_placements)
    return local_map(dense, out_placements=out, in_placements=ins,
                     in_grad_placements=grads, device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def _row_layouts(rows, reduce: str):
    """The placements of :func:`scatter_local`'s kinds, from the row-split
    array ``rows``: ``(row, gathered, partial, partial gradient)``."""
    row = tuple(Shard(0) if p == Shard(0) else Replicate()
                for p in rows.placements)
    return (row, (Replicate(),) * len(row),
            tuple(Partial(reduce) if p == Shard(0) else p for p in row),
            tuple(Partial() if p == Shard(0) else p for p in row))


def scatter_local(fn, rows, out, *args, reduce: str = "sum"):
    """``fn`` on this rank's shards of a scatter over the rows of a graph
    (its edges, or its nodes for a readout): a per-rank segment sum into a
    partial sum, a gather of node rows per edge.

    ``rows`` is an array laid out by rows (an edge array: the mesh
    dimensions where it is ``Shard(0)`` split the rows).  Each of ``args``
    is a pair ``(kind, x)``: kind ``"row"`` takes ``x`` laid out like
    ``rows`` (its gradient too); ``"all"`` gathers ``x`` whole to every
    rank, and its gradient is a partial sum over the row-splitting
    dimensions (each rank reads it for its own rows); ``None`` passes a
    value that is not a DTensor.  ``out`` is a kind or a tuple of kinds
    of ``fn``'s outputs: ``"row"``, or ``"partial"``, a ``Partial(reduce)``
    over the row-splitting dimensions (replicated over the others).  The
    MoE's groups run per rank the same way: DTensor has no rule for
    ``index_add``, ``scatter_reduce`` or ``index_copy``.  Off a mesh
    (``rows`` a plain tensor) it is ``fn`` on the tensors."""
    values = tuple(x for _, x in args)
    if not isinstance(rows, DTensor):
        return fn(*values)
    row, whole, partial, pgrad = _row_layouts(rows, reduce)
    place = {"row": row, "all": whole, None: None}
    grad = {"row": row, "all": pgrad, None: None}
    outs = {"row": row, "partial": partial}
    out_p = outs[out] if isinstance(out, str) else tuple(outs[k]
                                                         for k in out)
    return local_call(fn, out_p, tuple(place[k] for k, _ in args), *values,
                      grad_placements=tuple(grad[k] for k, _ in args))


def whole(x):
    """DTensor ``x`` whole on every rank (gathered, a partial sum reduced);
    plain tensors as they are."""
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, (Replicate(),) * x.device_mesh.ndim)


def partial_add(a, b):
    """``a + b`` of two DTensors of one layout that may hold partial sums,
    added on each rank so that a partial sum stays one (DTensor would
    reduce both first); plain tensors added."""
    if not isinstance(a, DTensor):
        return a + b
    place = tuple(a.placements)
    grad = tuple(Replicate() if isinstance(p, Partial) else p for p in place)
    return local_call(torch.add, place, (place, place), a, b,
                      grad_placements=(grad, grad))


def rowwise(fn, x, n_out: int = 1):
    """``fn`` along the last dimension of DTensor ``x``, on each rank's
    shard: the last dimension is gathered first if it is sharded, and the
    ``n_out`` outputs keep ``x``'s placements of the leading dimensions
    (a sort, a top-k or a one-hot of each row)."""
    last = x.ndim - 1
    place = tuple(p if isinstance(p, Shard) and p.dim != last
                  else Replicate() for p in x.placements)
    out = place if n_out == 1 else (place,) * n_out
    return local_call(fn, out, (place,), x)


def split_dim(x, dim: int, sizes):
    """``x`` with dimension ``dim`` split into ``sizes`` (a reshape).  A
    DTensor sharded along ``dim`` keeps its shards only where each holds
    whole rows of the leading size (8 KV heads of 128 merged, on a 16-way
    axis, do not): otherwise that dimension is gathered first."""
    shape = (*x.shape[:dim], *sizes, *x.shape[dim + 1:])
    if isinstance(x, DTensor):
        mesh = x.device_mesh
        n = math.prod(mesh.shape[i] for i, p in enumerate(x.placements)
                      if p == Shard(dim))
        if sizes[0] % n:
            x = x.redistribute(mesh, tuple(
                Replicate() if p == Shard(dim) else p for p in x.placements))
    return x.reshape(shape)


class _Merge(torch.autograd.Function):
    """Dimensions ``[dim, dim + len(sizes))`` of a DTensor merged into one,
    whose gradient is split back by :func:`split_dim`."""

    @staticmethod
    def forward(ctx, x, dim, sizes):
        ctx.dim, ctx.sizes = dim, sizes
        return x.reshape(*x.shape[:dim], -1, *x.shape[dim + len(sizes):])

    @staticmethod
    def backward(ctx, grad):
        return split_dim(grad, ctx.dim, ctx.sizes), None, None


def merge_dims(x, dim: int, n: int):
    """``x`` with dimensions ``[dim, dim + n)`` merged into one (a
    reshape); on a DTensor its gradient is split by :func:`split_dim`."""
    if isinstance(x, DTensor):
        return _Merge.apply(x, dim, tuple(x.shape[dim:dim + n]))
    return x.reshape(*x.shape[:dim], -1, *x.shape[dim + n:])


def whole_on_model(x):
    """DTensor ``x`` replicated over "model" (a shard gathered, a partial
    sum reduced), its other placements kept; plain tensors as they are.
    A decode step's attention and MLP outputs, partial sums over "model",
    are reduced so into the residual stream: left to DTensor, the stream
    is split over "model" by rows, and the next layer's projections then
    run on weights gathered whole on every rank."""
    if not isinstance(x, DTensor):
        return x
    names = x.device_mesh.mesh_dim_names or ()
    want = tuple(Replicate() if n == MODEL else p
                 for n, p in zip(names, x.placements))
    return x if want == tuple(x.placements) else x.redistribute(
        x.device_mesh, want)


def gathered(w):
    """A parameter gathered over its FSDP shards for use ("parameter
    shards gathered on use"), keeping its other shards; plain tensors as
    they are.  Its gradient is scattered back to the shards."""
    if not isinstance(w, DTensor):
        return w
    names = w.device_mesh.mesh_dim_names or ()
    want = tuple(Replicate() if names[i] == FSDP else p
                 for i, p in enumerate(w.placements))
    return w if want == tuple(w.placements) else w.redistribute(
        w.device_mesh, want)

