"""EquiformerV2-style equivariant graph attention with eSCN SO(2) convs
[arXiv:2306.12059] + eSCN [arXiv:2302.03655]: the JAX package's
``models/equiformer.py`` as plain tensor ops.

Features are SO(3) irreps ``X[N, (l_max+1)^2, C]`` (real spherical-harmonic
basis).  Per edge:

  1. build the rotation aligning the edge direction with +z;
  2. rotate source irreps into the edge frame with Wigner-D matrices;
  3. apply the eSCN SO(2) convolution — in the aligned frame an equivariant
     linear map only mixes components of equal |m|, and truncating to
     ``m <= m_max`` reduces the O(L^6) tensor product to O(L^3) mixes;
  4. modulate by radial features + graph-attention weights (invariant);
  5. rotate back and scatter-sum to the destination node.

Wigner-D matrices are built numerically: real SH satisfy
``Y_l(R x) = D_l(R) Y_l(x)``, so with a fixed generic sample set X the
per-degree ``pinv(Y_l(X))`` is computed once (numpy, cached) and per edge
``D_l = (pinv(Y_l(X)) @ Y_l(R X))^T``.  The pinvs are taken of this
module's own float32 SH values, so they differ from the JAX package's by
rounding.

The edge pipeline runs as a Python loop over edge chunks, each chunk
checkpointed while gradients are recorded (the JAX package's
``jax.checkpoint(nothing_saveable)`` around its scan body); above 1M
edges each layer is checkpointed too.  Each edge's Wigner blocks depend
on the geometry alone, so they are made once per forward, for every layer
and chunk (the JAX package remakes them in each chunk of each layer: the
same values, fewer operations).  The SO(2) convolution writes its output
out of place (``index_copy`` into zeros).

On a mesh the ``constrain`` calls are the JAX package's, call for call
(the edge geometry, the node state, the attention and radial weights,
each chunk's rotated sources and each layer's output).  The per-edge
work runs on each rank's own edges (``sharding.scatter_local``): it
reads the node rows from the node state gathered whole, loops over its
share of every chunk, and its node sums are partial sums over the
ranks that split the edges, added up over the chunks and reduced onto
the nodes' shards once per layer; the SO(2) output stays on the rank.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Shard
from torch.utils import checkpoint as ckpt

from . import sharding as shd
from .gnn import nll, segment_softmax, segment_sum_rows
from .params import ParamSpec, count_params

#: above this many edges each layer is checkpointed whole
BIG_GRAPH_EDGES = 1_000_000


# ---------------------------------------------------------------------------
# real spherical harmonics (vectorized, arbitrary l_max)
# ---------------------------------------------------------------------------

def real_sph_harm(dirs, l_max: int):
    """Real spherical harmonics Y_lm for unit vectors.

    dirs: [..., 3] -> [..., (l_max+1)^2] ordered (l, m) with
    m = -l..l (flat index l^2 + l + m), by the associated Legendre
    recursion in float32 (adequate for l <= 8).
    """
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    rxy = torch.sqrt(torch.clamp(x * x + y * y, min=1e-24))
    cos_t = torch.clamp(z, -1.0, 1.0)
    sin_t = rxy
    cos_p = x / rxy
    sin_p = y / rxy

    # P_l^m(cos_t) via stable recursion, including sin_t powers
    p = {(0, 0): torch.ones_like(cos_t)}
    for m in range(1, l_max + 1):
        p[(m, m)] = -(2 * m - 1) * sin_t * p[(m - 1, m - 1)]
    for m in range(0, l_max):
        p[(m + 1, m)] = (2 * m + 1) * cos_t * p[(m, m)]
    for m in range(0, l_max + 1):
        for l in range(m + 2, l_max + 1):
            p[(l, m)] = (
                (2 * l - 1) * cos_t * p[(l - 1, m)]
                - (l + m - 1) * p[(l - 2, m)]
            ) / (l - m)

    # cos(m phi), sin(m phi) by recursion
    cosm = [torch.ones_like(cos_p), cos_p]
    sinm = [torch.zeros_like(sin_p), sin_p]
    for m in range(2, l_max + 1):
        cosm.append(2 * cos_p * cosm[-1] - cosm[-2])
        sinm.append(2 * cos_p * sinm[-1] - sinm[-2])

    out = []
    for l in range(l_max + 1):
        for m in range(-l, l + 1):
            am = abs(m)
            norm = math.sqrt(
                (2 * l + 1) / (4 * math.pi)
                * math.factorial(l - am) / math.factorial(l + am)
            )
            if m == 0:
                val = norm * p[(l, 0)]
            elif m > 0:
                val = math.sqrt(2.0) * norm * p[(l, am)] * cosm[am]
            else:
                val = math.sqrt(2.0) * norm * p[(l, am)] * sinm[am]
            out.append(val)
    return torch.stack(out, dim=-1)


@functools.lru_cache(maxsize=8)
def _sample_pinv(l_max: int, n_samples: int = 24, seed: int = 7):
    """Fixed generic sample directions + per-degree pinv(Y_l(X)), as numpy
    arrays (moved to the device per call).  Host set-up, made outside any
    dispatch mode (the dry run's fake tensors and counters)."""
    from torch.utils._python_dispatch import _disable_current_modes

    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((n_samples, 3))
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    pts = pts.astype(np.float32)
    with _disable_current_modes():
        y = real_sph_harm(torch.from_numpy(pts), l_max).numpy()
    pinvs = []
    for l in range(l_max + 1):
        block = y[:, l * l: (l + 1) * (l + 1)]          # [K, 2l+1]
        pinvs.append(np.linalg.pinv(block).astype(np.float32))
    return pts, pinvs


def edge_alignment_rotation(rhat):
    """Rotation matrices R with R @ rhat = +z.  rhat: [E, 3] -> [E, 3, 3]."""
    x, y, z = rhat[:, 0], rhat[:, 1], rhat[:, 2]
    rxy = torch.sqrt(torch.clamp(x * x + y * y, min=1e-24))
    cos_a, sin_a = x / rxy, y / rxy      # azimuth
    cos_b, sin_b = z, rxy                # polar
    # R = Ry(-beta) @ Rz(-alpha)
    row0 = torch.stack([cos_b * cos_a, cos_b * sin_a, -sin_b], -1)
    row1 = torch.stack([-sin_a, cos_a, torch.zeros_like(x)], -1)
    row2 = torch.stack([sin_b * cos_a, sin_b * sin_a, cos_b], -1)
    return torch.stack([row0, row1, row2], dim=1)


def wigner_blocks(rot, l_max: int):
    """Per-degree Wigner-D for real SH. rot: [E, 3, 3] -> list of
    [E, 2l+1, 2l+1]."""
    pts, pinvs = _sample_pinv(l_max)
    pts = torch.as_tensor(pts, device=rot.device)
    rot_pts = torch.einsum("kj,eij->eki", pts, rot)      # [E, K, 3]  (R @ x_k)
    y_rot = real_sph_harm(rot_pts, l_max)                # [E, K, (L+1)^2]
    blocks = []
    for l in range(l_max + 1):
        yl = y_rot[..., l * l: (l + 1) * (l + 1)]        # [E, K, 2l+1]
        pinv = torch.as_tensor(pinvs[l], device=rot.device)
        d_t = torch.einsum("mk,ekn->emn", pinv, yl)      # D^T
        blocks.append(d_t.transpose(1, 2))
    return blocks


def rotate_irreps(x, blocks, *, inverse=False):
    """x: [E, (L+1)^2, C]; apply block-diag Wigner (or its transpose)."""
    outs = []
    for l, d in enumerate(blocks):
        seg = x[:, l * l: (l + 1) * (l + 1), :]
        # einsum "emn,enc->emc" (or "enm,...") as the batched product
        outs.append(torch.bmm(d.transpose(1, 2) if inverse else d, seg))
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# config / params
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EquiformerConfig:
    name: str
    n_layers: int = 12
    d_hidden: int = 128          # channels per irrep component
    l_max: int = 6
    m_max: int = 2
    n_heads: int = 8
    n_radial: int = 32           # radial basis size
    n_classes: int = 1           # regression target / class count
    readout: str = "graph"
    n_graphs: int = 0
    d_node_in: int = 16          # scalar input features
    edge_chunk: int = 0          # stream edges in chunks (0 = all at once)

    @property
    def n_irreps(self) -> int:
        return (self.l_max + 1) ** 2

    def m_rows(self, m: int) -> int:
        """Number of l-degrees carrying an |m|=m component."""
        return self.l_max + 1 - m

    def n_params(self) -> int:
        return count_params(equiformer_param_specs(self))


def equiformer_param_specs(cfg: EquiformerConfig) -> dict:
    f32 = torch.float32
    l, c = cfg.n_layers, cfg.d_hidden
    layer: dict[str, ParamSpec] = {
        # SO(2) conv weights per |m|: mix (l-degree x channel) jointly
        "w_m0": ParamSpec(
            (l, cfg.m_rows(0) * c, cfg.m_rows(0) * c), f32,
            (None, None, shd.MODEL)),
        "ln_scale": ParamSpec((l, cfg.l_max + 1, c), f32,
                              (None, None, None), init="ones"),
        "gate_w": ParamSpec((l, c, cfg.l_max * c), f32,
                            (None, None, shd.MODEL)),
        "attn_w": ParamSpec((l, c + cfg.n_radial, cfg.n_heads), f32,
                            (None, None, None)),
        "radial_w1": ParamSpec((l, cfg.n_radial, c), f32,
                               (None, None, shd.MODEL)),
        "radial_b1": ParamSpec((l, c), f32, (None, None), init="zeros"),
        "ffn_w1": ParamSpec((l, c, c), f32, (None, None, shd.MODEL)),
        "ffn_w2": ParamSpec((l, c, c), f32, (None, shd.MODEL, None)),
    }
    for m in range(1, cfg.m_max + 1):
        rows = cfg.m_rows(m) * c
        layer[f"w_m{m}_r"] = ParamSpec((l, rows, rows), f32,
                                       (None, None, shd.MODEL))
        layer[f"w_m{m}_i"] = ParamSpec((l, rows, rows), f32,
                                       (None, None, shd.MODEL))
    return {
        "embed_w": ParamSpec((cfg.d_node_in, c), f32, (None, shd.MODEL)),
        "layers": layer,
        "head_w": ParamSpec((c, cfg.n_classes), f32, (None, None)),
        "head_b": ParamSpec((cfg.n_classes,), f32, (None,), init="zeros"),
    }


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _radial_basis(dist, n_radial: int, r_cut: float = 6.0, mesh=None):
    """Gaussian radial basis [E, n_radial]."""
    centers = shd.replicate(torch.linspace(
        0.0, r_cut, n_radial, device=dist.device), mesh)
    gamma = n_radial / r_cut
    return torch.exp(-gamma * torch.square(dist[:, None] - centers[None, :]))


def _m_index_sets(cfg: EquiformerConfig):
    """Flat irrep indices carrying each |m| (per sign)."""
    idx0 = [l * l + l for l in range(cfg.l_max + 1)]
    pos, neg = {}, {}
    for m in range(1, cfg.m_max + 1):
        pos[m] = [l * l + l + m for l in range(m, cfg.l_max + 1)]
        neg[m] = [l * l + l - m for l in range(m, cfg.l_max + 1)]
    return idx0, pos, neg


def _so2_conv(x_edge, lp, cfg: EquiformerConfig):
    """eSCN SO(2) convolution in the aligned frame. x_edge: [E, I, C].

    The components of each |m| <= m_max are mixed and written into zeros
    in one ``index_copy``; those with |m| > m_max stay zero (the eSCN
    truncation)."""
    e, _, c = x_edge.shape
    idx0, pos, neg = _m_index_sets(cfg)

    def take(idx):
        rows = torch.as_tensor(idx, device=x_edge.device)
        return x_edge.index_select(1, rows).reshape(e, -1)

    # m = 0: plain linear over (l, channel)
    outs = [(take(idx0) @ lp["w_m0"]).reshape(e, len(idx0), c)]
    where = list(idx0)
    # |m| > 0: complex-structured pair mixing (SO(2) equivariance)
    for m in range(1, cfg.m_max + 1):
        xp, xm = take(pos[m]), take(neg[m])
        wr, wi = lp[f"w_m{m}_r"], lp[f"w_m{m}_i"]
        outs.append((xp @ wr - xm @ wi).reshape(e, len(pos[m]), c))
        outs.append((xp @ wi + xm @ wr).reshape(e, len(pos[m]), c))
        where += pos[m] + neg[m]
    return torch.zeros_like(x_edge).index_copy(
        1, torch.as_tensor(where, device=x_edge.device), torch.cat(outs, 1))


def _equivariant_ln(x, scale, cfg: EquiformerConfig):
    """Norm over each degree-l block, learned per-(l, channel) scale."""
    outs = []
    for l in range(cfg.l_max + 1):
        seg = x[:, l * l: (l + 1) * (l + 1), :]
        norm = torch.sqrt(torch.mean(torch.sum(seg * seg, dim=1), dim=-1)
                          + 1e-6)
        outs.append(seg / norm[:, None, None] * scale[l][None, None, :])
    return torch.cat(outs, dim=1)


def _so2_names(cfg: EquiformerConfig) -> list[str]:
    """The SO(2) convolution's weights of a layer."""
    return ["w_m0"] + [f"w_m{m}_{p}" for m in range(1, cfg.m_max + 1)
                       for p in "ri"]


def _chunk_sum(y, lp, cfg: EquiformerConfig, edges, i: int, n_chunks: int,
               mesh):
    """Chunk ``i`` of the edges' messages summed into the nodes ``[N, I,
    C]``: rotate ``y[src]`` into each edge's frame (its Wigner blocks in
    ``edges``), SO(2) conv, modulate by the radial and attention weights,
    rotate back, zero the masked edges, add by destination.  On a mesh each rank takes chunk ``i`` of
    its own edges and its sum is a partial sum."""
    src, dst, blocks, radial, alpha_c, edge_mask = edges
    n = y.shape[0]
    n_blocks = cfg.l_max + 1

    def part(e):
        k = e.shape[0] // n_chunks
        return slice(i * k, (i + 1) * k)

    def rotate_in(y_, s_, *blocks_):
        p = part(s_)
        return rotate_irreps(y_[s_[p].long()], [b[p] for b in blocks_])

    x_e = shd.scatter_local(rotate_in, src, "row", ("all", y),
                            ("row", src), *(("row", b) for b in blocks))
    x_e = shd.constrain(x_e, mesh, shd.BATCH, None, shd.MODEL)
    names = _so2_names(cfg)

    def rotate_out(x_, d_, rad, al, m_, *rest):
        p = part(d_)
        blocks_ = [b[p] for b in rest[:n_blocks]]
        ws = rest[n_blocks:]
        msg = _so2_conv(x_, dict(zip(names, ws)), cfg)
        msg = msg * (rad[p] * al[p])[:, None, :]
        msg = rotate_irreps(msg, blocks_, inverse=True)
        msg = torch.where(m_[p][:, None, None], msg, 0.0)
        return msg.new_zeros((n, *msg.shape[1:])).index_add_(
            0, d_[p].long(), msg)

    return shd.scatter_local(
        rotate_out, src, "partial", ("row", x_e), ("row", dst),
        ("row", radial), ("row", alpha_c), ("row", edge_mask),
        *(("row", b) for b in blocks), *(("all", lp[k]) for k in names))


def _checkpointed(fn):
    """``fn`` checkpointed (nothing saved, all recomputed in the backward
    pass) while gradients are recorded; ``fn`` itself otherwise."""
    if not torch.is_grad_enabled():
        return fn
    return functools.partial(ckpt.checkpoint, fn, use_reentrant=False)


def _layer(x, lp, cfg: EquiformerConfig, edges, n_chunks: int, mesh=None):
    """One equivariant attention layer and its gated FFN on ``x``."""
    src, dst, blocks, rbf, edge_mask, e_spec = edges
    n, _, c = x.shape
    y = _equivariant_ln(x, lp["ln_scale"], cfg)
    # pass 1 — invariant attention logits from node scalars + distance
    inv = shd.scatter_local(
        lambda y0, s_, d_, r_: torch.cat([y0[s_.long()] + y0[d_.long()],
                                          r_], dim=-1),
        src, "row", ("all", y[:, 0, :]), ("row", src), ("row", dst),
        ("row", rbf))
    logits = inv @ lp["attn_w"]                            # [E, heads]
    alpha = segment_softmax(logits, dst, n, edge_mask)     # [E, heads]
    alpha_c = shd.scatter_local(                           # [E, C]
        lambda a: a.repeat_interleave(c // cfg.n_heads, dim=1), src, "row",
        ("row", alpha))
    alpha_c = shd.constrain(alpha_c, mesh, e_spec, None)
    radial = F.silu(rbf @ lp["radial_w1"] + lp["radial_b1"])
    radial = shd.constrain(radial, mesh, e_spec, None)

    # pass 2 — chunked equivariant messages, each chunk recomputed in the
    # backward pass so the per-edge irrep intermediates stay O(chunk)
    chunk_sum = _checkpointed(_chunk_sum)
    chunk_edges = (src, dst, blocks, radial, alpha_c, edge_mask)
    # the node state the chunks read from, gathered once per layer when
    # there are several (one chunk gathers it itself, inside its
    # checkpoint, so the gathered copy is not kept for the backward)
    y_all = shd.whole(y) if n_chunks > 1 else y
    agg = None
    for i in range(n_chunks):
        part = chunk_sum(y_all, lp, cfg, chunk_edges, i, n_chunks, mesh)
        agg = part if agg is None else shd.partial_add(agg, part)
    if shd.on_mesh(mesh):
        agg = agg.redistribute(mesh, x.placements)
    x = x + agg

    # gated equivariant FFN
    y2 = _equivariant_ln(x, lp["ln_scale"], cfg)
    scalar = y2[:, 0, :]
    h0 = F.silu(scalar @ lp["ffn_w1"]) @ lp["ffn_w2"]
    gates = torch.sigmoid(scalar @ lp["gate_w"])           # [N, l_max*C]
    upd = [h0[:, None, :]]
    for l in range(1, cfg.l_max + 1):
        seg = y2[:, l * l: (l + 1) * (l + 1), :]
        upd.append(seg * gates[:, (l - 1) * c:l * c][:, None, :])
    return shd.constrain(x + torch.cat(upd, dim=1), mesh, shd.BATCH, None,
                         shd.MODEL)


def _embed(h, n_irreps: int):
    """``[N, C]`` scalars into ``[N, n_irreps, C]`` irreps, the higher
    degrees zero (on a mesh per rank, on ``h``'s shards)."""
    def local(h_):
        return torch.cat([h_[:, None, :], h_.new_zeros(
            (h_.shape[0], n_irreps - 1, h_.shape[1]))], dim=1)

    if not isinstance(h, DTensor):
        return local(h)
    hp = tuple(h.placements)
    out = tuple(Shard(2) if p == Shard(1) else p for p in hp)
    return shd.local_call(local, out, (hp,), h)


def forward(params, g, cfg: EquiformerConfig, mesh=None):
    """g: node_feat [N, d_in], positions [N, 3], edge_src/dst, masks.

    When ``cfg.edge_chunk > 0`` the per-edge irrep pipeline (Wigner blocks,
    SO(2) conv, rotate-back) runs over edge chunks, so its intermediates
    are O(chunk * (l_max+1)^2 * C) instead of O(E * ...); the edge count
    must split into whole chunks.  Attention uses invariant node scalars +
    distances only, so the softmax normalizer is computed over all edges
    before the chunked sweep (two-pass attention).
    """
    n = g["node_feat"].shape[0]
    src, dst = g["edge_src"], g["edge_dst"]

    rel = shd.scatter_local(lambda pos, s_, d_: pos[s_.long()] - pos[
        d_.long()], src, "row", ("all", g["positions"]), ("row", src),
        ("row", dst))
    dist = torch.sqrt(torch.sum(rel * rel, dim=-1) + 1e-12)
    # zero-length edges (self-loops / padding) have no direction: their
    # alignment rotation would be singular and break equivariance — mask them.
    edge_mask = g["edge_mask"] & (dist > 1e-5)
    e_total = src.shape[0]
    e_spec = shd.EDGE if e_total > BIG_GRAPH_EDGES else shd.BATCH
    rhat = shd.constrain(rel / dist[:, None], mesh, e_spec, None)
    rbf = shd.constrain(_radial_basis(dist, cfg.n_radial, mesh=mesh), mesh,
                        e_spec, None)

    # init: scalar channel from inputs, higher degrees zero
    x = _embed(g["node_feat"] @ params["embed_w"], cfg.n_irreps)
    x = shd.constrain(x, mesh, shd.BATCH, None, shd.MODEL)

    chunk = cfg.edge_chunk or e_total
    n_chunks = max(e_total // chunk, 1)
    if e_total % n_chunks:
        raise ValueError(f"{e_total} edges do not split into {n_chunks} "
                         f"chunks of edge_chunk={cfg.edge_chunk}")
    # each edge's Wigner blocks, made once for every layer and chunk: they
    # depend on the geometry alone
    blocks = shd.scatter_local(
        lambda r_: tuple(wigner_blocks(edge_alignment_rotation(r_),
                                       cfg.l_max)), src,
        ("row",) * (cfg.l_max + 1), ("row", rhat))
    edges = (src, dst, tuple(blocks), rbf, edge_mask, e_spec)
    layer = _layer
    # checkpoint whole layers on big graphs: only the [N, irreps, C] state
    # survives the forward; everything per-edge is recomputed in backward
    if e_total > BIG_GRAPH_EDGES:
        layer = _checkpointed(_layer)
    slices = {k: w.unbind(0) for k, w in params["layers"].items()}
    for i in range(cfg.n_layers):
        lp = {k: w[i] for k, w in slices.items()}
        x = layer(x, lp, cfg, edges, n_chunks, mesh)

    scalars = torch.where(g["node_mask"][:, None], x[:, 0, :], 0.0)
    if cfg.readout == "graph":
        pooled = segment_sum_rows(scalars, g["graph_ids"], cfg.n_graphs)
        return pooled @ params["head_w"] + params["head_b"]
    return scalars @ params["head_w"] + params["head_b"]


def loss_fn(params, batch, cfg: EquiformerConfig, mesh=None):
    """Mean squared error of the first output against ``targets`` when
    ``n_classes == 1`` (regression); else the negative log-likelihood of
    ``labels``, averaged over graphs or over the nodes of ``node_mask``."""
    out = forward(params, batch, cfg, mesh)
    if cfg.n_classes == 1:   # regression (molecule energies)
        target = batch["targets"].to(torch.float32)
        return torch.mean(torch.square(out[:, 0] - target))
    losses = nll(out, batch["labels"])
    if cfg.readout == "graph":
        return torch.mean(losses)
    mask = batch["node_mask"].to(torch.float32)
    return torch.sum(losses * mask) / torch.clamp(torch.sum(mask), min=1.0)
