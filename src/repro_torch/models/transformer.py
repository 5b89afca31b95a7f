"""Decoder-only transformer LM (dense, sliding-window and MoE) for
training and serving: the JAX package's ``models/transformer.py`` as plain
tensor ops.

Layer parameters are stacked on a leading ``[L]`` axis, as in the JAX
package (so its parameter trees and checkpoints carry over); the layer
scan is a Python loop over that axis, and each layer's local/global
choice and RoPE theta come from its index, which gives the same result
as the JAX package's mask and theta blend.  Every parameter carries its
logical partition spec as data (:mod:`.sharding`).

``remat`` checkpoints each layer when gradients are being recorded, as
the JAX package's ``jax.checkpoint`` around the scanned layer does:
``"full"`` keeps only the layer's inputs (``nothing_saveable``),
``"dots"`` also keeps the outputs of the projections without batch
dimensions (``aten.mm``/``aten.addmm``, as ``dots_with_no_batch_dims_
saveable``) and recomputes the rest, attention's batched products among
them, and ``"none"`` keeps everything.  ``microbatch_override`` is read by
:func:`repro_torch.configs.common.choose_microbatches`.  The JAX config's
``unroll_scans`` (a compile-time knob of its dry run) is not a field here.

``serve_step`` writes the new token's K/V into the cache it is given, in
place, and returns that cache: the JAX function returns a new cache, and
copying a whole cache per token would double a decode step's traffic.
Like the JAX package (``dynamic_update_slice``), it writes every batch
row at the one position ``cache_len``, clamped to the cache's last slot.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils import checkpoint as ckpt

from . import attention, moe as moe_lib, sharding as shd
from .layers import cross_entropy_loss, rms_norm, rope_angles, rotate, \
    scalar_in, swiglu
from .params import ParamSpec, count_params, tree_init


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    rope_theta: float = 1e4
    rope_theta_local: float | None = None
    qkv_bias: bool = False
    tie_embeddings: bool = False
    embed_scale: bool = False
    window: int | None = None         # sliding window for local layers
    pattern_local: int = 0            # e.g. 5 local : 1 global (gemma3)
    pattern_global: int = 1
    # MoE
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    n_shared_experts: int = 0
    dense_residual: bool = False      # arctic: dense FFN parallel to MoE
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    # numerics / memory
    dtype: Any = torch.bfloat16
    remat: str = "full"               # full | dots | none
    q_chunk: int = 512
    gather_dtype: str = "f32"         # "bf16": layer params cast first
    microbatch_override: int = 0      # force grad-accumulation factor

    @property
    def has_dense_mlp(self) -> bool:
        return (not self.moe) or self.dense_residual

    def n_params(self) -> int:
        return count_params(param_specs(self))


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def param_specs(cfg: TransformerConfig) -> dict:
    l, d = cfg.n_layers, cfg.d_model
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    f32 = torch.float32
    layer: dict[str, ParamSpec] = {
        "ln1": ParamSpec((l, d), f32, (None, None), init="zeros"),
        "ln2": ParamSpec((l, d), f32, (None, None), init="zeros"),
        "wq": ParamSpec((l, d, h, dh), f32, (None, shd.FSDP, shd.MODEL, None)),
        "wk": ParamSpec((l, d, kv, dh), f32, (None, shd.FSDP, shd.MODEL, None)),
        "wv": ParamSpec((l, d, kv, dh), f32, (None, shd.FSDP, shd.MODEL, None)),
        "wo": ParamSpec((l, h, dh, d), f32, (None, shd.MODEL, None, shd.FSDP)),
    }
    if cfg.qkv_bias:
        layer["bq"] = ParamSpec((l, h, dh), f32, (None, shd.MODEL, None),
                                init="zeros")
        layer["bk"] = ParamSpec((l, kv, dh), f32, (None, shd.MODEL, None),
                                init="zeros")
        layer["bv"] = ParamSpec((l, kv, dh), f32, (None, shd.MODEL, None),
                                init="zeros")
    if cfg.has_dense_mlp:
        f = cfg.d_ff
        layer["wg"] = ParamSpec((l, d, f), f32, (None, shd.FSDP, shd.MODEL))
        layer["wu"] = ParamSpec((l, d, f), f32, (None, shd.FSDP, shd.MODEL))
        layer["wd"] = ParamSpec((l, f, d), f32, (None, shd.MODEL, shd.FSDP))
    if cfg.moe:
        e, fe = cfg.n_experts, cfg.d_ff_expert
        layer["w_router"] = ParamSpec((l, d, e), f32, (None, shd.FSDP, None))
        layer["we_gate"] = ParamSpec(
            (l, e, d, fe), f32, (None, shd.MODEL, shd.FSDP, None))
        layer["we_up"] = ParamSpec(
            (l, e, d, fe), f32, (None, shd.MODEL, shd.FSDP, None))
        layer["we_down"] = ParamSpec(
            (l, e, fe, d), f32, (None, shd.MODEL, None, shd.FSDP))
        if cfg.n_shared_experts:
            fs = cfg.n_shared_experts * fe
            layer["ws_gate"] = ParamSpec(
                (l, d, fs), f32, (None, shd.FSDP, shd.MODEL))
            layer["ws_up"] = ParamSpec(
                (l, d, fs), f32, (None, shd.FSDP, shd.MODEL))
            layer["ws_down"] = ParamSpec(
                (l, fs, d), f32, (None, shd.MODEL, shd.FSDP))
    specs = {
        "embed": ParamSpec((cfg.vocab, d), f32, (shd.MODEL, None),
                           init="embed", scale=d ** -0.5),
        "layers": layer,
        "final_norm": ParamSpec((d,), f32, (None,), init="zeros"),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((d, cfg.vocab), f32,
                                     (shd.FSDP, shd.MODEL))
    return specs


def init_params(cfg: TransformerConfig, *, generator: torch.Generator,
                device=None):
    """Seeded parameters by :func:`param_specs` (on CUDA unless
    ``device`` is given)."""
    return tree_init(param_specs(cfg), generator=generator, device=device)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _is_local_layer(cfg: TransformerConfig, idx: int) -> bool:
    if cfg.window is None or cfg.pattern_local == 0:
        return False
    return idx % (cfg.pattern_local + cfg.pattern_global) < cfg.pattern_local


def _rope_theta(cfg: TransformerConfig, is_local: bool) -> float:
    if is_local and cfg.rope_theta_local is not None:
        return cfg.rope_theta_local
    return cfg.rope_theta


def _rope_tables(cfg: TransformerConfig, positions, mesh=None) -> dict:
    """``{theta: (sin, cos)}`` for every RoPE theta the layers use (local
    vs global layers), made once per call (replicated on a mesh)."""
    thetas = {_rope_theta(cfg, _is_local_layer(cfg, i))
              for i in range(cfg.n_layers)}
    return {t: tuple(shd.replicate(x, mesh)
                     for x in rope_angles(positions, cfg.d_head, t))
            for t in thetas}


def _lookup_sharded(table, tokens):
    """``table[tokens]`` on DTensors: the table gathered over its
    vocabulary shards, and each rank looking up its own tokens (DTensor's
    rules for a lookup into a sharded table give a partial sum that can
    be reduced once, and none for tokens split over two mesh axes)."""
    mesh = table.device_mesh
    tp = tuple(p if isinstance(p, Shard) else Replicate()
               for p in tokens.placements)
    rep = (Replicate(),) * mesh.ndim
    # each rank's tokens reach other rows of the table: partial gradients
    grad = tuple(Partial() if isinstance(p, Shard) else p for p in tp)
    return shd.local_call(lambda t, ids: t[ids], tp, (rep, tp), table,
                          tokens, grad_placements=(grad, tp))


def _embed(params, tokens, cfg: TransformerConfig):
    table = params["embed"]
    if isinstance(table, DTensor):
        x = _lookup_sharded(table, tokens)
    else:
        x = table[tokens]
    x = x.to(cfg.dtype)
    if cfg.embed_scale:
        x = x * scalar_in(math.sqrt(cfg.d_model), cfg.dtype)
    return x


def _project(h, w, bias=None):
    """``einsum("bsd,dhk->bshk", h, w)`` (+ bias), in ``h``'s dtype."""
    out = shd.split_dim(h @ shd.merge_dims(shd.gathered(w).to(h.dtype), 1,
                                       w.ndim - 1),
                        h.ndim - 1, w.shape[1:])
    return out if bias is None else out + bias.to(h.dtype)


def _qkv(cfg: TransformerConfig, h, lp, rope, is_local):
    """q and k rotated by the layer's RoPE table in ``rope``, and v."""
    bias = cfg.qkv_bias
    q = _project(h, lp["wq"], lp["bq"] if bias else None)
    k = _project(h, lp["wk"], lp["bk"] if bias else None)
    v = _project(h, lp["wv"], lp["bv"] if bias else None)
    sincos = rope[_rope_theta(cfg, is_local)]
    return rotate(q, *sincos), rotate(k, *sincos), v


def _attn_out(out, lp, dtype):
    """``einsum("bshk,hkd->bsd", out, wo)``."""
    wo = shd.gathered(lp["wo"]).to(dtype)
    return shd.merge_dims(out, 2, 2) @ shd.merge_dims(wo, 0, 2)


def _mlp(cfg: TransformerConfig, mesh, h, lp):
    """The dense MLP, the MoE block and the shared experts of one layer
    on ``h [B, S, D]``."""
    out = None
    if cfg.has_dense_mlp:
        out = swiglu(h, lp["wg"], lp["wu"], lp["wd"])
    if cfg.moe:
        b, s, d = h.shape
        moe_out = shd.split_dim(moe_lib.moe_block(
            shd.merge_dims(h, 0, 2), w_router=lp["w_router"],
            w_gate=lp["we_gate"], w_up=lp["we_up"], w_down=lp["we_down"],
            top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
            mesh=mesh,
        ), 0, (b, s))
        out = moe_out if out is None else out + moe_out
        if cfg.n_shared_experts:
            out = out + swiglu(h, lp["ws_gate"], lp["ws_up"], lp["ws_down"])
    return out


def _layer_fwd(cfg: TransformerConfig, mesh, x, lp, idx: int, positions,
               rope):
    """One decoder layer. x: [B, S, D]; lp: the layer's parameter slice."""
    is_local = _is_local_layer(cfg, idx)
    h = rms_norm(x, lp["ln1"])
    q, k, v = _qkv(cfg, h, lp, rope, is_local)
    q = shd.constrain(q, mesh, shd.BATCH, None, shd.MODEL, None)
    k = shd.constrain(k, mesh, shd.BATCH, None, shd.MODEL, None)
    out = attention.attend_chunked(
        q, k, v, q_positions=positions, kv_positions=positions,
        causal=True, window=cfg.window, is_local=is_local,
        scale=cfg.d_head ** -0.5, q_chunk=min(cfg.q_chunk, x.shape[1]),
    )
    x = x + shd.constrain(_attn_out(out, lp, cfg.dtype), mesh, shd.BATCH,
                          None, None)
    h = rms_norm(x, lp["ln2"])
    x = x + shd.constrain(_mlp(cfg, mesh, h, lp), mesh, shd.BATCH, None,
                          None)
    aux = shd.replicate(torch.zeros((), dtype=torch.float32,
                                    device=x.device), mesh)
    if cfg.moe:
        aux = moe_lib.aux_load_balance_loss(
            h.reshape(-1, h.shape[-1]), lp["w_router"], top_k=cfg.top_k)
    return x, aux


def _logits(params, x, cfg: TransformerConfig):
    x = rms_norm(x, params["final_norm"])
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ shd.gathered(head).to(cfg.dtype)


_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """Keep the outputs of 2-D matmuls (the projections), recompute the
    rest."""
    if op in _SAVED_DOTS:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _layer_call(cfg: TransformerConfig, mesh, idx: int, positions, rope):
    """Layer ``idx`` as ``fn(x, lp) -> (x, aux)`` on its parameter slice
    ``lp`` (cast when ``gather_dtype == "bf16"``), under the config's
    checkpoint when gradients are being recorded."""

    def layer(x, lp):
        if cfg.gather_dtype == "bf16":
            lp = {k: w.to(cfg.dtype) for k, w in lp.items()}
        return _layer_fwd(cfg, mesh, x, lp, idx, positions, rope)

    if cfg.remat not in ("full", "dots", "none"):
        raise ValueError(f"remat {cfg.remat!r}: full, dots or none")
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return layer
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _dots_policy)
    return functools.partial(ckpt.checkpoint, layer, use_reentrant=False,
                             **kw)


def forward(params, tokens, cfg: TransformerConfig, mesh=None):
    """tokens [B, S] -> (logits [B, S, V] float32, summed aux loss).

    The stacked ``[L, ...]`` layer parameters are unbound once, so their
    gradients are stacked once in the backward pass (indexing ``w[i]``
    per layer would add a zero-filled ``[L, ...]`` gradient per layer).
    """
    x = shd.constrain(_embed(params, tokens, cfg), mesh, shd.BATCH, None,
                      None)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    rope = _rope_tables(cfg, positions[None, :], mesh)
    slices = {k: w.unbind(0) for k, w in params["layers"].items()}
    auxes = []
    for i in range(cfg.n_layers):
        lp = {k: w[i] for k, w in slices.items()}
        x, aux = _layer_call(cfg, mesh, i, positions, rope)(x, lp)
        auxes.append(aux)
    logits = shd.constrain(_logits(params, x, cfg), mesh, shd.BATCH, None,
                           shd.MODEL)
    return logits.to(torch.float32), torch.stack(auxes).sum()


def loss_fn(params, batch, cfg: TransformerConfig, mesh=None):
    logits, aux = forward(params, batch["tokens"], cfg, mesh)
    loss = cross_entropy_loss(logits, batch["targets"])
    if cfg.moe:
        loss = loss + cfg.aux_loss_weight * aux / cfg.n_layers
    return loss


# ---------------------------------------------------------------------------
# serving (decode with KV cache)
# ---------------------------------------------------------------------------

def cache_specs(cfg: TransformerConfig, batch: int, max_len: int) -> dict:
    l, kv, dh = cfg.n_layers, cfg.n_kv_heads, cfg.d_head
    shape = (l, batch, max_len, kv, dh)
    logical = (None, shd.BATCH, shd.SEQ, shd.MODEL, None)
    return {
        "k": ParamSpec(shape, cfg.dtype, logical, init="zeros"),
        "v": ParamSpec(shape, cfg.dtype, logical, init="zeros"),
    }


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               device=None) -> dict:
    """A zeroed KV cache (on CUDA unless ``device`` is given)."""
    from repro_torch.core.executor import resolve_device

    device = resolve_device(device)
    return {k: torch.zeros(s.shape, dtype=s.dtype, device=device)
            for k, s in cache_specs(cfg, batch, max_len).items()}


def _write_slot(cache, new, slot: int) -> None:
    """``cache[:, slot] = new[:, 0]`` in place (cache ``[B, T, KV, dh]``,
    new ``[B, 1, KV, dh]``).  On a DTensor cache sharded along its
    sequence, the rank whose slice holds ``slot`` writes it into its
    shard; ``new`` is laid out like the cache first."""
    if not isinstance(cache, DTensor):
        cache[:, slot] = new[:, 0]
        return
    place = tuple(Replicate() if p == Shard(1) else p
                  for p in cache.placements)
    new = new.redistribute(cache.device_mesh, place).to_local()
    local = cache.to_local()
    at = slot - shd.shard_offset(cache, 1)
    if 0 <= at < local.shape[1]:
        local[:, at] = new[:, 0]


def serve_step(params, cache, tokens, cache_len, cfg: TransformerConfig,
               mesh=None):
    """Decode one token. tokens [B, 1]; cache_len: valid entries so far.

    Returns (logits [B, V] float32, the cache, updated in place).
    """
    cache_len = int(cache_len)
    x = _embed(params, tokens, cfg)
    rope = _rope_tables(cfg, torch.full((1, 1), cache_len,
                                        device=tokens.device), mesh)
    t_max = cache["k"].shape[2]
    # dynamic_update_slice clamps the start into the cache
    slot = min(max(cache_len, 0), t_max - 1)
    # one mask per kind of layer (local, global), made once per step
    masks = {loc: attention.decode_mask(
        t_max, cache_len=cache_len + 1, window=cfg.window, is_local=loc,
        device=tokens.device)
        for loc in {_is_local_layer(cfg, i) for i in range(cfg.n_layers)}}
    for i in range(cfg.n_layers):
        lp = {k: w[i] for k, w in params["layers"].items()}
        is_local = _is_local_layer(cfg, i)
        h = rms_norm(x, lp["ln1"])
        q, k, v = _qkv(cfg, h, lp, rope, is_local)
        k_cache, v_cache = cache["k"][i], cache["v"][i]
        _write_slot(k_cache, k, slot)
        _write_slot(v_cache, v, slot)
        out = attention.attend_decode(
            q, k_cache, v_cache, cache_len=cache_len + 1,
            window=cfg.window, is_local=is_local, scale=cfg.d_head ** -0.5,
            mask=masks[is_local],
        )
        x = x + shd.whole_on_model(_attn_out(out, lp, cfg.dtype))
        x = x + shd.whole_on_model(_mlp(cfg, mesh, rms_norm(x, lp["ln2"]),
                                        lp))
    return _logits(params, x, cfg)[:, 0].to(torch.float32), cache
