"""The embedding bag (B5) of the port against the JAX package.

The plain version (``repro_torch.kernels.embedding_bag.ref.embedding_bag``,
what ``ops.embedding_bag`` runs on CPU tensors) is held against the JAX
oracle ``ref.embedding_bag`` (``jnp.take`` + einsum) and against
``recsys.embedding_bag(use_pallas=False)``; the grouped form
(``ref.embedding_bag_fields``: every field's bag after the dense columns,
DCN-v2's x0) against the JAX oracle per field and ``jnp.concatenate``.  Not against the Pallas kernel:
it does not run on this tree's jax (``pl.load`` is gone in 0.9.0).
Tolerances are the JAX tests': 1e-5 for f32 (the K products summed in
another order), 5e-2 for bf16 (the oracle sums in bf16, the port in fp32
and rounds once).  The CUDA kernel runs on the card only
(``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag import ref as jax_ref
from repro.models import recsys as jax_recsys
from repro_torch.kernels.embedding_bag import ops, ref

SHAPES = [(1000, 16, 64, 4), (5000, 64, 100, 1), (300, 128, 257, 8)]
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-2)}


def _inputs(v, d, b, k, seed, lo=0, hi=None):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((v, d)).astype(np.float32)
    ids = rng.integers(lo, v if hi is None else hi, (b, k)).astype(np.int32)
    weights = rng.standard_normal((b, k)).astype(np.float32)
    return table, ids, weights


def _f32(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("v,d,b,k", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_matches_jax_oracle_and_model_path(v, d, b, k, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    table, ids, weights = _inputs(v, d, b, k, v + b)
    tt = torch.as_tensor(table).to(tdt)
    got = ops.embedding_bag(tt, torch.as_tensor(ids),
                            torch.as_tensor(weights))
    assert got.dtype == tdt and got.shape == (b, d)
    assert torch.equal(got, ref.embedding_bag(tt, torch.as_tensor(ids),
                                              torch.as_tensor(weights)))
    jt, ji, jw = (jnp.asarray(table, jdt), jnp.asarray(ids),
                  jnp.asarray(weights))
    for want in (jax_ref.embedding_bag(jt, ji, jw),
                 jax_recsys.embedding_bag(jt, ji, jw, use_pallas=False)):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


def test_duplicate_ids_in_bag():
    """Repeated ids accumulate (bag semantics, not set semantics)."""
    table = np.eye(8, 4, dtype=np.float32)
    ids = np.asarray([[2, 2, 2, 0]], np.int32)
    weights = np.asarray([[1.0, 2.0, 3.0, 10.0]], np.float32)
    out = ops.embedding_bag(*(torch.as_tensor(x)
                              for x in (table, ids, weights))).numpy()
    want = np.asarray(jax_ref.embedding_bag(*(jnp.asarray(x) for x in (
        table, ids, weights))))
    np.testing.assert_allclose(out, want)
    assert out[0, 2] == 6.0 and out[0, 0] == 10.0


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ids_outside_the_table_follow_jnp_take(dtype):
    """A negative id >= -V wraps; any other id outside [0, V) gives a NaN
    row, whatever its weight, as ``jnp.take`` gives."""
    jdt, tdt, tol = DTYPES[dtype]
    v, d = 50, 8
    table, ids, weights = _inputs(v, d, 40, 3, 21, lo=-2 * v, hi=2 * v)
    weights[0, 0] = 0.0
    assert (ids < -v).any() and (ids >= v).any()
    assert ((ids < 0) & (ids >= -v)).any()
    got = ops.embedding_bag(torch.as_tensor(table).to(tdt),
                            torch.as_tensor(ids), torch.as_tensor(weights))
    want = jax_ref.embedding_bag(jnp.asarray(table, jdt), jnp.asarray(ids),
                                 jnp.asarray(weights))
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol,
                               equal_nan=True)
    bad = ((ids < -v) | (ids >= v)).any(1)
    assert np.isnan(_f32(got)[bad]).all()
    assert np.isfinite(_f32(got)[~bad]).all()


def test_field_views_of_a_batch():
    """The wrapper takes ``[B, K]`` field slices of a ``[B, F, K]`` batch
    as they are, and they give what contiguous copies give."""
    rng = np.random.default_rng(4)
    table = torch.as_tensor(rng.standard_normal((30, 4)).astype(np.float32))
    ids = torch.as_tensor(rng.integers(0, 30, (16, 5, 3)).astype(np.int32))
    w = torch.as_tensor(rng.standard_normal((16, 5, 3)).astype(np.float32))
    for f in range(5):
        assert not ids[:, f].is_contiguous()
        assert torch.equal(ops.embedding_bag(table, ids[:, f], w[:, f]),
                           ops.embedding_bag(table, ids[:, f].contiguous(),
                                             w[:, f].contiguous()))


def test_wrapper_refuses_what_the_kernel_does_not_take():
    table = torch.zeros((5, 4))
    ids = torch.zeros((2, 3), dtype=torch.int32)
    w = torch.ones((2, 3))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.launch_kernel(table, ids, w)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.embedding_bag(table.to("meta"), ids.to("meta"), w.to("meta"))
    with pytest.raises(ValueError, match="weights has shape"):
        ops.embedding_bag(table, ids, w[:, :2])
    with pytest.raises(ValueError, match="expected \\[B, K\\]"):
        ops.embedding_bag(table, ids[0], w[0])


def test_kernel_matches_plain_on_gpu():
    """B5 against its plain version on the card, on the JAX test shapes in
    both dtypes and with ids outside the table; skips on a host without
    one (chip_smoke.py runs the same checks there)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py covers the kernel")
    for v, d, b, k in SHAPES:
        for _, tdt, tol in DTYPES.values():
            table, ids, weights = _inputs(v, d, b, k, v + b, lo=-v - 3,
                                          hi=v + 3)
            args = [torch.as_tensor(x, device="cuda")
                    for x in (table, ids, weights)]
            args[0] = args[0].to(tdt)
            got = ops.embedding_bag(*args)
            want = ref.embedding_bag(args[0].float(), *args[1:])
            torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol,
                                       equal_nan=True)


def _fields_inputs(b, seed, vocabs=(100, 7, 1000, 50, 3, 20_000), d=8, k=3,
                   n_dense=5):
    """A ``[B, F, K]`` batch over tables of mixed vocabularies, with ids
    outside the tables and negative ids; ids, weights and dense columns
    are strided views of larger arrays."""
    rng = np.random.default_rng(seed)
    tables = [rng.standard_normal((v, d)).astype(np.float32) for v in vocabs]
    ids = np.stack([rng.integers(-v - 3, v + 3, (b, 2 * k))
                    for v in vocabs for _ in (0, 1)], 1).astype(np.int32)
    weights = rng.standard_normal((b, 2 * len(vocabs), k)).astype(np.float32)
    dense = rng.standard_normal((b, 2 * n_dense)).astype(np.float32)
    return (tables, ids[:, ::2, ::2], weights[:, 1::2], dense[:, ::2])


@pytest.mark.parametrize("with_dense", [True, False])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_fields_plain_matches_jax_per_field_concat(dtype, with_dense):
    jdt, tdt, tol = DTYPES[dtype]
    tables, ids, weights, dense = _fields_inputs(37, 8)
    assert (ids < 0).any() and any((ids[:, f] >= len(t)).any()
                                   for f, t in enumerate(tables))
    t_ids, t_w, t_dense = (torch.from_numpy(x) for x in (ids, weights,
                                                         dense))
    assert not t_ids.is_contiguous() and not t_w.is_contiguous()
    got = ops.embedding_bag_fields(
        [torch.as_tensor(t).to(tdt) for t in tables], t_ids, t_w,
        t_dense if with_dense else None)
    bags = [jax_ref.embedding_bag(jnp.asarray(t, jdt), jnp.asarray(ids[:, f]),
                                  jnp.asarray(weights[:, f]))
            for f, t in enumerate(tables)]
    want = jnp.concatenate(([jnp.asarray(dense)] if with_dense else [])
                           + bags, axis=-1)
    assert got.dtype == (torch.float32 if with_dense else tdt)
    assert got.shape == want.shape == (37, (5 if with_dense else 0)
                                       + 8 * len(tables))
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol,
                               equal_nan=True)
    assert np.isnan(_f32(got)).any() and np.isfinite(_f32(got)).any()


def test_one_field_equals_the_single_field_path():
    table, ids, weights = _inputs(300, 16, 50, 4, 3, lo=-310, hi=310)
    tt, ti, tw = (torch.as_tensor(x) for x in (table, ids, weights))
    one = ops.embedding_bag_fields([tt], ti[:, None], tw[:, None])
    torch.testing.assert_close(one, ops.embedding_bag(tt, ti, tw), rtol=0,
                               atol=0, equal_nan=True)
    assert one.isnan().any()


def _into_x0(tables, ids, weights, dense):
    """x0 as 26 single-field calls would write it: the dense columns
    copied, then each field's bags into its columns (rows strided)."""
    d, nd = tables[0].shape[1], dense.shape[1]
    x0 = torch.full((ids.shape[0], nd + len(tables) * d), -7.0,
                    dtype=dense.dtype, device=dense.device)
    x0[:, :nd].copy_(dense)
    for f, t in enumerate(tables):
        cols = x0[:, nd + f * d:nd + (f + 1) * d]
        assert cols.stride(0) == x0.shape[1]
        assert ops.embedding_bag(t, ids[:, f], weights[:, f], out=cols) \
            .data_ptr() == cols.data_ptr()
    return x0


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_out_writes_one_fields_columns_of_x0(dtype):
    """``out=`` puts one field's bags into its columns of a wider x0 and
    returns it: field by field, that is the grouped form exactly."""
    _, tdt, _ = DTYPES[dtype]
    tables, ids, weights, dense = _fields_inputs(23, 9)
    tabs = [torch.as_tensor(t).to(tdt) for t in tables]
    t_ids, t_w = torch.from_numpy(ids), torch.from_numpy(weights)
    t_dense = torch.from_numpy(dense).to(tdt)
    got = _into_x0(tabs, t_ids, t_w, t_dense)
    want = ops.embedding_bag_fields(tabs, t_ids, t_w, t_dense)
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    with pytest.raises(ValueError, match="out is"):
        ops.embedding_bag(tabs[0], t_ids[:, 0], t_w[:, 0],
                          out=torch.empty((23, 8), dtype=torch.float64))
    with pytest.raises(ValueError, match="out is"):
        ops.embedding_bag(tabs[0], t_ids[:, 0], t_w[:, 0],
                          out=torch.empty((23, 9), dtype=tdt))


def test_fields_wrapper_refuses_mixed_tables_and_bad_shapes():
    tables = [torch.zeros((5, 4)), torch.zeros((7, 4))]
    ids = torch.zeros((2, 2, 3), dtype=torch.int32)
    w = torch.ones((2, 2, 3))
    with pytest.raises(TypeError, match="table 1 has dtype"):
        ops.embedding_bag_fields([tables[0], tables[1].bfloat16()], ids, w)
    with pytest.raises(ValueError, match="table 1 has width 6"):
        ops.embedding_bag_fields([tables[0], torch.zeros((7, 6))], ids, w)
    with pytest.raises(ValueError, match="expected \\[B, 3, K\\]"):
        ops.embedding_bag_fields(tables + [tables[0]], ids, w)
    with pytest.raises(ValueError, match="weights has shape"):
        ops.embedding_bag_fields(tables, ids, w[:, :, :2])
    with pytest.raises(ValueError, match="dense has shape"):
        ops.embedding_bag_fields(tables, ids, w, torch.zeros((3, 4)))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.launch_fields_kernel(tables, ids, w)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.embedding_bag_fields([t.to("meta") for t in tables],
                                 ids.to("meta"), w.to("meta"))


def test_out_kernel_writes_x0_in_place_on_gpu():
    """The single-field kernel writing each field's columns of x0 (rows
    strided) gives the grouped launch's x0 bitwise, f32 and bf16; skips
    on a host without a card (chip_smoke.py does the same at serve_bulk).
    """
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py covers the kernel")
    for b in (5, 512, 3000):
        tables, ids, weights, dense = _fields_inputs(b, b)
        args = [torch.from_numpy(x).cuda() for x in (ids, weights, dense)]
        for _, tdt, _ in DTYPES.values():
            tabs = [torch.as_tensor(t, device="cuda").to(tdt) for t in tables]
            x = args[2].to(tdt)
            torch.testing.assert_close(
                _into_x0(tabs, args[0], args[1], x),
                ops.embedding_bag_fields(tabs, args[0], args[1], x),
                rtol=0, atol=0, equal_nan=True)


def test_fields_kernel_matches_plain_on_gpu():
    """The grouped B5 against its plain version on the card, f32 and bf16,
    with and without dense columns; skips on a host without one
    (chip_smoke.py runs the same checks there)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py covers the kernel")
    for b in (5, 512, 3000):
        tables, ids, weights, dense = _fields_inputs(b, b)
        args = [torch.from_numpy(x).cuda() for x in (ids, weights, dense)]
        for _, tdt, tol in DTYPES.values():
            tabs = [torch.as_tensor(t, device="cuda").to(tdt) for t in tables]
            for x in (args[2], None):
                got = ops.embedding_bag_fields(tabs, args[0], args[1], x)
                want = ref.embedding_bag_fields(
                    [t.float() for t in tabs], args[0], args[1], x)
                torch.testing.assert_close(got.float(), want, rtol=tol,
                                           atol=tol, equal_nan=True)
