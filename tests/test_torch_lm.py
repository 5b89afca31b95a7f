"""The port's LM zoo (serving half of slice 9) against the JAX package:
layers, attention, MoE routing and dispatch, the five transformer archs'
forward, loss and decode, the serving engine, configs and the LM data
pipeline.

Parameters are made by the JAX package's ``transformer.init_params`` and
carried across with ``convert.params_from_numpy``; tokens come from numpy
seeds.  Tolerances:
- float32 layers and attention: rtol 1e-5, atol 1e-5 x the output's
  largest magnitude (XLA and PyTorch's CPU kernels sum in other orders);
- bfloat16 layers, attention and models: rtol 1e-3, atol 1e-3 x the
  largest magnitude, a quarter of one bf16 ulp (2^-8 ~ 3.9e-3 relative):
  both sides round at the same points, so they read equal but for a
  float32 loss's last bits or a rare ulp in a cache, and a port that
  computed in float32 instead fails it (``test_bf16_forward_matches_jax``);
- whole float32 smoke models (forward logits, aux, loss, decode logits
  and caches): rtol 1e-4, atol 1e-4 x the largest magnitude, as the JAX
  zoo's own decode-vs-prefill test (2e-4) allows for a model's depth;
- MoE top-k, dispatch slots, keep flags, sort order and greedy engine
  tokens: exact.
"""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import common as jax_common
from repro.configs import get_arch as jax_get_arch
from repro.configs import lm_arch_names as jax_lm_arch_names
from repro.data import lm_pipeline as jax_lm_pipeline
from repro.models import attention as jax_attention
from repro.models import layers as jax_layers
from repro.models import moe as jax_moe
from repro.models import params as jax_params
from repro.models import transformer as jax_transformer
from repro.serving import engine as jax_engine
from repro_torch import configs
from repro_torch.configs import common
from repro_torch.core import convert
from repro_torch.data import lm_pipeline
from repro_torch.models import attention, layers, moe, params, sharding
from repro_torch.models import transformer
from repro_torch.serving import engine
from torch_corpus import gloo_mesh

ARCHS = ["granite-8b", "gemma3-1b", "qwen2-72b", "moonshot-v1-16b-a3b",
         "arctic-480b"]
F32, BF16 = (1e-5, "float32"), (1e-3, "bfloat16")
MODEL_TOL = 1e-4


def _np(x):
    if torch.is_tensor(x):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    atol = tol * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=tol, atol=atol)


def _pair(arr, dtype):
    """The same numpy array as a JAX array and a CPU tensor of ``dtype``."""
    j = jnp.asarray(arr, getattr(jnp, dtype))
    return j, convert.params_from_numpy({"x": np.asarray(j)}, "cpu")["x"]


def _smoke(name, **replace):
    jcfg = dataclasses.replace(jax_get_arch(name).smoke_config, **replace)
    return jcfg, convert.transformer_config_from(jcfg)


def _weights(jcfg, seed=0):
    # jitted: one compile instead of one per leaf shape, the same draws
    jp = jax.jit(functools.partial(jax_transformer.init_params, cfg=jcfg))(
        jax.random.PRNGKey(seed))
    return jp, convert.params_from_numpy(jp, "cpu")


@functools.cache
def _model(name):
    """``(jax config, config, jax params, params)`` of an arch's smoke
    config, made once per test process (no test writes to them)."""
    jcfg, cfg = _smoke(name)
    return (jcfg, cfg, *_weights(jcfg))


# -- layers ------------------------------------------------------------------

@pytest.mark.parametrize("tol,dtype", [F32, BF16], ids=["f32", "bf16"])
def test_layers_match_jax(tol, dtype):
    rng = np.random.default_rng(0)
    jx, x = _pair(rng.normal(size=(2, 5, 4, 16)), dtype)
    jw, w = _pair(rng.normal(size=(16,)) * 0.1, dtype)
    _close(layers.rms_norm(x, w), jax_layers.rms_norm(jx, jw), tol)
    pos = np.arange(5, dtype=np.int32)[None] + 3
    for theta in (1e4, 1e6):
        _close(layers.apply_rope(x, torch.as_tensor(pos), theta=theta),
               jax_layers.apply_rope(jx, jnp.asarray(pos), theta=theta),
               tol)
    jh, h = _pair(rng.normal(size=(3, 7, 16)), dtype)
    mats = [_pair(rng.normal(size=s) * 0.2, dtype)
            for s in ((16, 24), (16, 24), (24, 16))]
    _close(layers.swiglu(h, *(m[1] for m in mats)),
           jax_layers.swiglu(jh, *(m[0] for m in mats)), tol)
    _close(layers.gelu_mlp(h, mats[0][1], mats[2][1]),
           jax_layers.gelu_mlp(jh, mats[0][0], mats[2][0]), tol)
    jl, lg = _pair(rng.normal(size=(3, 7, 50)) * 3, dtype)
    tgt = rng.integers(0, 50, (3, 7)).astype(np.int32)
    for z in (0.0, 1e-3):
        _close(layers.cross_entropy_loss(lg, torch.as_tensor(tgt), z_loss=z),
               jax_layers.cross_entropy_loss(jl, jnp.asarray(tgt), z_loss=z),
               tol)


# -- attention ---------------------------------------------------------------

ATTN_CASES = [
    dict(window=None, is_local=False, soft_cap=None),
    dict(window=6, is_local=True, soft_cap=None),
    dict(window=6, is_local=False, soft_cap=None),
    dict(window=6, is_local=True, soft_cap=5.0),
    dict(window=None, is_local=False, soft_cap=2.0),
]


@pytest.mark.parametrize("tol,dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ATTN_CASES,
                         ids=lambda c: "-".join(f"{k}{v}" for k, v in
                                                c.items()))
def test_attention_matches_jax(case, tol, dtype):
    rng = np.random.default_rng(1)
    b, s, n_q, n_kv, dh, q_chunk = 2, 16, 4, 2, 8, 4
    jq, q = _pair(rng.normal(size=(b, s, n_q, dh)), dtype)
    jk, k = _pair(rng.normal(size=(b, s, n_kv, dh)), dtype)
    jv, v = _pair(rng.normal(size=(b, s, n_kv, dh)), dtype)
    pos = np.arange(s, dtype=np.int32)
    kw = dict(window=case["window"], scale=dh ** -0.5,
              soft_cap=case["soft_cap"])
    got = attention.attend_chunked(
        q, k, v, q_positions=torch.as_tensor(pos),
        kv_positions=torch.as_tensor(pos), is_local=case["is_local"],
        q_chunk=q_chunk, **kw)
    want = jax_attention.attend_chunked(
        jq, jk, jv, q_positions=jnp.asarray(pos), kv_positions=jnp.asarray(pos),
        is_local=jnp.asarray(case["is_local"]), q_chunk=q_chunk, **kw)
    _close(got, want, tol)
    # decode: the query at position cache_len - 1 of a longer cache
    for cache_len in (3, 11, s):
        got = attention.attend_decode(
            q[:, cache_len - 1:cache_len], k, v, cache_len=cache_len,
            is_local=case["is_local"], **kw)
        want = jax_attention.attend_decode(
            jq[:, cache_len - 1:cache_len], jk, jv, cache_len=cache_len,
            is_local=jnp.asarray(case["is_local"]), **kw)
        _close(got, want, tol)


def test_attend_chunked_refuses_a_ragged_split():
    """10 positions in chunks of 3: 3 chunks of 3 leave one out, and the
    JAX function's reshape fails; the port raises."""
    q, k = np.zeros((1, 10, 2, 4), np.float32), np.zeros((1, 10, 1, 4),
                                                          np.float32)
    pos = np.arange(10, dtype=np.int32)
    with pytest.raises(TypeError):
        jax_attention.attend_chunked(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(k),
            q_positions=jnp.asarray(pos), kv_positions=jnp.asarray(pos),
            scale=0.5, q_chunk=3)
    with pytest.raises(ValueError, match="query chunks"):
        attention.attend_chunked(
            torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(k),
            q_positions=torch.as_tensor(pos), kv_positions=torch.as_tensor(pos),
            scale=0.5, q_chunk=3)


# -- MoE -----------------------------------------------------------------------

def test_router_topk_breaks_ties_by_lower_index():
    """All-equal probabilities: top-k is experts 0..k-1, as in lax.top_k."""
    x = np.random.default_rng(2).normal(size=(5, 8)).astype(np.float32)
    w = np.zeros((8, 64), np.float32)
    jw_, je = jax_moe.router_topk(jnp.asarray(x), jnp.asarray(w), top_k=6)
    tw, te = moe.router_topk(torch.as_tensor(x), torch.as_tensor(w), top_k=6)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(te.numpy(), np.tile(np.arange(6), (5, 1)))
    _close(tw, jw_, 1e-6)
    # and the aux loss, which ranks the same way
    _close(moe.aux_load_balance_loss(torch.as_tensor(x), torch.as_tensor(w),
                                     top_k=6),
           jax_moe.aux_load_balance_loss(jnp.asarray(x), jnp.asarray(w),
                                         top_k=6), 1e-6)


def test_dispatch_and_combine_match_jax_with_drops():
    rng = np.random.default_rng(3)
    t, d, e, k, f = 24, 8, 4, 2, 12
    x = rng.normal(size=(t, d)).astype(np.float32)
    w_router = rng.normal(size=(d, e)).astype(np.float32)
    jwts, jexp = jax_moe.router_topk(jnp.asarray(x), jnp.asarray(w_router),
                                     top_k=k)
    wts, exp = moe.router_topk(torch.as_tensor(x), torch.as_tensor(w_router),
                               top_k=k)
    np.testing.assert_array_equal(exp.numpy(), np.asarray(jexp))
    capacity = max(int(t * k * 0.5 / e), 1)          # 6 of 12 per expert
    jout = jax_moe._dispatch_group(jnp.asarray(x), jexp, n_experts=e,
                                   capacity=capacity, top_k=k)
    out = moe._dispatch_group(torch.as_tensor(x), exp, n_experts=e,
                              capacity=capacity, top_k=k)
    assert not bool(out[2].all()), "the capacity drops no assignment"
    for name, got, want in zip(("slot", "keep", "order"), out[1:], jout[1:]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), name)
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(jout[0]))
    ob = rng.normal(size=(e, capacity, d)).astype(np.float32)
    _close(moe._combine_group(torch.as_tensor(ob), *out[1:], wts, top_k=k),
           jax_moe._combine_group(jnp.asarray(ob), *jout[1:], jwts, top_k=k),
           1e-5)
    experts = [rng.normal(size=s).astype(np.float32) * 0.3
               for s in ((e, d, f), (e, d, f), (e, f, d))]
    for cf, n_tok in ((0.5, t), (8.0, t), (1.25, 3 * 4096 + 12)):
        xx = rng.normal(size=(n_tok, d)).astype(np.float32)
        kw = dict(top_k=k, capacity_factor=cf, group_size=4096)
        got = moe.moe_block(torch.as_tensor(xx),
                            w_router=torch.as_tensor(w_router),
                            w_gate=torch.as_tensor(experts[0]),
                            w_up=torch.as_tensor(experts[1]),
                            w_down=torch.as_tensor(experts[2]), **kw)
        want = jax.jit(functools.partial(jax_moe.moe_block, **kw))(
            jnp.asarray(xx), w_router=jnp.asarray(w_router),
            w_gate=jnp.asarray(experts[0]), w_up=jnp.asarray(experts[1]),
            w_down=jnp.asarray(experts[2]))
        _close(got, want, 1e-5)


# -- the five archs ------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_smoke_model_matches_jax(name):
    """forward logits and aux, loss_fn, then 12 serve_step logits and
    caches (past gemma's window of 8) against the JAX package."""
    jcfg, cfg, jp, p = _model(name)
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, jcfg.vocab, (2, 32)).astype(np.int32)
    batch = {"tokens": tokens, "targets": np.roll(tokens, -1, 1)}
    (jlogits, jaux), jloss = jax.jit(lambda p_, b: (
        jax_transformer.forward(p_, b["tokens"], jcfg),
        jax_transformer.loss_fn(p_, b, jcfg)))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    logits, aux = transformer.forward(p, torch.as_tensor(tokens), cfg)
    _close(logits, jlogits, MODEL_TOL)
    _close(aux, jaux, MODEL_TOL)
    assert float(aux) > 0 if jcfg.moe else float(aux) == 0
    loss = transformer.loss_fn(
        p, {k: torch.as_tensor(v) for k, v in batch.items()}, cfg)
    _close(loss, jloss, MODEL_TOL)

    step = jax.jit(lambda p_, c, t, i: jax_transformer.serve_step(
        p_, c, t, i, jcfg, None))
    jcache = jax_transformer.init_cache(jcfg, 2, 16)
    cache = transformer.init_cache(cfg, 2, 16, device="cpu")
    for i in range(12):
        jl, jcache = step(jp, jcache, jnp.asarray(tokens[:, i:i + 1]),
                          jnp.asarray(i, jnp.int32))
        lg, cache = transformer.serve_step(
            p, cache, torch.as_tensor(tokens[:, i:i + 1]), i, cfg)
        _close(lg, jl, MODEL_TOL)
    for key in ("k", "v"):
        _close(cache[key], jcache[key], MODEL_TOL)


def _err(got, want) -> float:
    """The least ``tol`` with which ``_close(got, want, tol)`` passes."""
    got, want = _np(got), _np(want)
    return float((np.abs(got - want)
                  / (np.abs(want) + np.abs(want).max())).max())


#: XLA may keep a fused chain of bfloat16 ops in float32 and round once at
#: its end; switched off, the JAX package rounds at every op it writes
EXACT_BF16 = {"xla_allow_excess_precision": False}


@pytest.mark.parametrize("name", ["gemma3-1b", "moonshot-v1-16b-a3b"])
def test_bf16_forward_matches_jax(name):
    """The bf16 rounding points (embed scale, norms, RoPE, probabilities
    cast to v's dtype, the MoE router in f32, layer params cast before
    use) at the compute dtype of the full configs: ``forward`` on float32
    params with ``gather_dtype="bf16"``, then 12 ``serve_step`` logits and
    caches (past gemma's window of 8) on bf16 serving params, against the
    JAX package compiled with ``EXACT_BF16``, at the bf16 tolerance.

    Readings on the CPU (``_err``): the port reads 0 on every logit and at
    most 1.0e-4 on the caches (moonshot: 2 entries of k one bf16 ulp
    apart).  The control, the port computing in float32 on the same
    bf16-rounded weights, reads 3.4e-3 (gemma forward), 3.6e-3 (gemma
    steps), 5.3e-3 (gemma caches), 8.3e-3, 1.14e-2 and 5.8e-3 (moonshot):
    every one fails the tolerance, which the control asserts."""
    tol = BF16[0]
    jcfg, cfg = _smoke(name, dtype=jnp.bfloat16, gather_dtype="bf16")
    assert cfg.dtype == torch.bfloat16
    ctl = dataclasses.replace(cfg, dtype=torch.float32)
    jp, p = _weights(jcfg, seed=1)
    tokens = np.random.default_rng(5).integers(
        0, jcfg.vocab, (2, 16)).astype(np.int32)
    jtok = jnp.asarray(tokens)
    jlogits, _ = jax.jit(lambda p_, t: jax_transformer.forward(
        p_, t, jcfg)).lower(jp, jtok).compile(EXACT_BF16)(jp, jtok)
    tok = torch.as_tensor(tokens)
    _close(transformer.forward(p, tok, cfg)[0], jlogits, tol)
    jserve = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    serve = convert.params_from_numpy(jserve, "cpu")
    assert _err(transformer.forward(serve, tok, ctl)[0], jlogits) > tol

    jcache = jax_transformer.init_cache(jcfg, 2, 16)
    step = jax.jit(lambda p_, c, t, i: jax_transformer.serve_step(
        p_, c, t, i, jcfg, None)).lower(
        jserve, jcache, jtok[:, :1], jnp.asarray(0, jnp.int32)).compile(
        EXACT_BF16)
    cache = transformer.init_cache(cfg, 2, 16, device="cpu")
    ctl_cache = transformer.init_cache(ctl, 2, 16, device="cpu")
    ctl_err = 0.0
    for i in range(12):
        jl, jcache = step(jserve, jcache, jtok[:, i:i + 1],
                          jnp.asarray(i, jnp.int32))
        lg, cache = transformer.serve_step(serve, cache, tok[:, i:i + 1], i,
                                           cfg)
        _close(lg, jl, tol)
        lg, ctl_cache = transformer.serve_step(serve, ctl_cache,
                                               tok[:, i:i + 1], i, ctl)
        ctl_err = max(ctl_err, _err(lg, jl))
    assert ctl_err > tol
    for key in ("k", "v"):
        _close(cache[key], jcache[key], tol)
    assert max(_err(ctl_cache[key], jcache[key]) for key in "kv") > tol


@pytest.mark.parametrize("name", ARCHS)
def test_decode_matches_prefill(name):
    """The JAX zoo's case on the port: greedy decode logits match the
    teacher-forced forward's (rtol 2e-4, atol 2e-4, as there)."""
    _, cfg, _, p = _model(name)
    tokens = torch.as_tensor(
        np.random.default_rng(3).integers(0, cfg.vocab, (2, 8)))
    full, _ = transformer.forward(p, tokens, cfg)
    cache = transformer.init_cache(cfg, 2, 16, device="cpu")
    for i in range(8):
        logits, cache = transformer.serve_step(p, cache, tokens[:, i:i + 1],
                                               i, cfg)
    np.testing.assert_allclose(logits.numpy(), full[:, -1].numpy(),
                               rtol=2e-4, atol=2e-4)


def test_serve_step_clamps_the_cache_write():
    """Past the cache's end the write lands in the last slot, as
    ``dynamic_update_slice`` clamps it; every row is written."""
    jcfg, cfg, jp, p = _model("granite-8b")
    tok = np.array([[3], [7]], np.int32)
    jcache = jax_transformer.init_cache(jcfg, 2, 4)
    cache = transformer.init_cache(cfg, 2, 4, device="cpu")
    jl, jcache = jax_transformer.serve_step(jp, jcache, jnp.asarray(tok), 6,
                                            jcfg)
    lg, cache = transformer.serve_step(p, cache, torch.as_tensor(tok), 6, cfg)
    _close(lg, jl, MODEL_TOL)
    _close(cache["k"], jcache["k"], MODEL_TOL)
    assert bool((cache["k"][:, :, 3] != 0).all())
    assert not bool(cache["k"][:, :, :3].any())


def test_param_trees_and_counts_match_jax():
    for name in ARCHS:
        jarch, arch = jax_get_arch(name), configs.get_arch(name)
        assert arch.family == "lm" and arch.shapes == common.LM_SHAPES
        assert convert.transformer_config_from(jarch.config) == arch.config
        assert convert.transformer_config_from(jarch.smoke_config) \
            == arch.smoke_config
        full = arch.config
        assert full.n_params() == jarch.config.n_params()
        assert common.lm_active_params(full) \
            == jax_common.lm_active_params(jarch.config)
        want = jax.tree.leaves(jax_common._serve_param_specs(jarch.config),
                               is_leaf=jax_params.is_spec)
        got = params.tree_leaves(common.serve_param_specs(full))
        assert [tuple(s.shape) for s in got] == [tuple(s.shape) for s in want]
        assert [s.logical for s in got] == [s.logical for s in want]
        assert {s.dtype for s in got} == {torch.bfloat16}
    assert configs.lm_arch_names() == jax_lm_arch_names()
    assert [(s.name, s.seq_len, s.global_batch, s.kind)
            for s in common.LM_SHAPES] == [
        (s.name, s.seq_len, s.global_batch, s.kind)
        for s in jax_common.LM_SHAPES]
    # the nameplate numbers
    assert configs.get_arch("granite-8b").config.n_params() == 8_053_362_688
    moon = configs.get_arch("moonshot-v1-16b-a3b").config
    assert (moon.n_params(), common.lm_active_params(moon)) == (
        28_888_467_456, 4_804_773_888)
    assert configs.get_arch("equiformer-v2").family == "gnn"


def test_constrain_is_the_identity_on_one_device(tmp_path):
    x = torch.arange(6.0).reshape(2, 3)
    assert sharding.constrain(x, None, sharding.BATCH, None) is x
    with gloo_mesh(tmp_path) as mesh:
        assert sharding.constrain(x, mesh, sharding.BATCH, None) is x
    # on a larger mesh a plain tensor has no layout to redistribute
    four = types.SimpleNamespace(size=lambda: 4)
    with pytest.raises(TypeError, match="DTensor"):
        sharding.constrain(x, four, sharding.BATCH, None)


# -- serving engine, data, example ---------------------------------------------

# prompts drawn once from np.random.default_rng(0): with two slots the
# first request's decode reads cache rows the second one's prefill wrote
# (the JAX engine's cross-slot writes), so its tokens differ from one slot
PROMPTS = [[166, 233, 128, 155, 248], [161, 139, 143, 239], [5, 6, 7]]


def test_engine_matches_jax_token_for_token():
    jcfg, cfg, jp, p = _model("granite-8b")
    outs = {}
    for slots in (1, 2):
        want = jax_engine.ServingEngine(jcfg, jp, slots=slots, max_len=32).run(
            [jax_engine.Request(prompt=q, max_new_tokens=6) for q in PROMPTS])
        got = engine.ServingEngine(cfg, p, slots=slots, max_len=32).run(
            [engine.Request(prompt=q, max_new_tokens=6) for q in PROMPTS])
        assert [r.out for r in got] == [r.out for r in want]
        assert all(r.done for r in got)
        outs[slots] = [r.out for r in got]
    assert outs[1][0] != outs[2][0], "no cross-slot write showed"
    # a request that reaches max_len stops there, as in the JAX engine
    long = [[1, 2, 3, 4, 5, 6]]
    want = jax_engine.ServingEngine(jcfg, jp, slots=1, max_len=9).run(
        [jax_engine.Request(prompt=q, max_new_tokens=8) for q in long])
    got = engine.ServingEngine(cfg, p, slots=1, max_len=9).run(
        [engine.Request(prompt=q, max_new_tokens=8) for q in long])
    assert [r.out for r in got] == [r.out for r in want]
    assert len(got[0].out) < 8


def test_lm_pipeline_matches_jax():
    kw = dict(batch=3, seq_len=10, vocab=97)
    ours, theirs = lm_pipeline.batches(7, **kw), jax_lm_pipeline.batches(7, **kw)
    for _ in range(3):
        (t, y), (jt_, jy) = next(ours), next(theirs)
        np.testing.assert_array_equal(t, jt_)
        np.testing.assert_array_equal(y, jy)
        assert t.dtype == np.int32


def test_serve_lm_example_on_cpu(capsys):
    from repro_torch.examples import serve_lm

    assert serve_lm.main(["--device", "cpu", "--steps", "30"]) == 0
    out = capsys.readouterr().out
    assert "warmup train loss" in out
    assert out.count("request ") == 3
