"""The segment scatter-sum (B4) of the port against the JAX package.

The plain version (``repro_torch.kernels.segment_spmm.ref.scatter_sum``,
what ``ops.scatter_sum`` runs on CPU tensors) is held against the JAX
wrapper ``ops.scatter_sum`` (the Pallas kernel in interpret mode, as the
JAX tests run it) and against the JAX oracle ``ref.scatter_sum``
(``jax.ops.segment_sum``).  Tolerances are the JAX tests': 1e-5 for f32
(both sum each segment's rows in fp32, in another order), and for bf16
2e-2 relative / 0.15 absolute against the fp32 oracle (the bf16 inputs and
the rounding of the sums on the way out).  The CUDA kernel runs on the
card only (``chip_smoke.py``); here its wrapper's sort and sentinel are
checked by summing through the permutation on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.segment_spmm import ops as jax_ops
from repro.kernels.segment_spmm import ref as jax_ref
from repro_torch.kernels.segment_spmm import ops, ref

SHAPES = [(100, 40, 8), (1000, 128, 64), (513, 300, 70), (2048, 64, 128)]
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2, 0.15)}


def _inputs(e, n, d, seed, ids=None):
    rng = np.random.default_rng(seed)
    values = rng.standard_normal((e, d)).astype(np.float32)
    seg = rng.integers(0, n, e).astype(np.int32) if ids is None else ids(rng)
    return values, seg


def _f32(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _through_permutation(values, seg, n, mask=None):
    """What the kernel computes from the wrapper's sort, summed on the CPU
    in the kernel's order: each segment's rows in ascending sorted order."""
    sorted_ids, order = ops.sort_rows(seg, n, mask)
    assert sorted_ids.dtype == torch.int32 and order.dtype == torch.int64
    offsets = torch.searchsorted(sorted_ids, torch.arange(n + 1,
                                                          dtype=torch.int32))
    out = torch.zeros((n, values.shape[1]), dtype=torch.float32)
    for s in range(n):
        for r in range(int(offsets[s]), int(offsets[s + 1])):
            out[s] += values[order[r]].float()
    return out.to(values.dtype)


@pytest.mark.parametrize("e,n,d", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_matches_jax_kernel_and_oracle(e, n, d, dtype):
    jdt, tdt, rtol, atol = DTYPES[dtype]
    values, seg = _inputs(e, n, d, e + n + d)
    jv = jnp.asarray(values, jdt)
    tv = torch.as_tensor(values).to(tdt)
    got = ops.scatter_sum(tv, torch.as_tensor(seg), n)
    assert got.dtype == tdt and got.shape == (n, d)
    assert torch.equal(got, ref.scatter_sum(tv, torch.as_tensor(seg), n))
    jax_kernel = jax_ops.scatter_sum(jv, jnp.asarray(seg), n)
    oracle = jax_ref.scatter_sum(jv.astype(jnp.float32), jnp.asarray(seg), n)
    for want in (jax_kernel, oracle):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=rtol,
                                   atol=atol)


def test_mask():
    e, n, d = 500, 100, 32
    values, seg = _inputs(e, n, d, 7)
    mask = np.random.default_rng(8).random(e) < 0.7
    got = ops.scatter_sum(torch.as_tensor(values), torch.as_tensor(seg), n,
                          torch.as_tensor(mask))
    for want in (jax_ops.scatter_sum(jnp.asarray(values), jnp.asarray(seg),
                                     n, jnp.asarray(mask)),
                 jax_ref.scatter_sum(jnp.asarray(values), jnp.asarray(seg),
                                     n, jnp.asarray(mask))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def test_empty_and_hot_segments():
    """Skew: 80% of the rows land in one segment, many segments empty
    (1e-4 as in the JAX test: ~640 rows summed into one segment)."""
    e, n, d = 800, 256, 16
    values, seg = _inputs(e, n, d, 9, ids=lambda rng: np.where(
        rng.random(e) < 0.8, 3, rng.integers(0, n, e)).astype(np.int32))
    got = ops.scatter_sum(torch.as_tensor(values), torch.as_tensor(seg), n)
    assert int((got.abs().sum(1) == 0).sum()) > 0        # empty segments
    for want in (jax_ops.scatter_sum(jnp.asarray(values), jnp.asarray(seg),
                                     n),
                 jax_ref.scatter_sum(jnp.asarray(values), jnp.asarray(seg),
                                     n)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)


def test_out_of_range_and_negative_ids_are_dropped():
    """Ids outside [0, n), negative ones included, are dropped, as
    ``jax.ops.segment_sum`` and the JAX wrapper drop them."""
    e, n, d = 600, 50, 24
    values, seg = _inputs(e, n, d, 12, ids=lambda rng: rng.integers(
        -60, n + 60, e).astype(np.int32))
    assert (seg < 0).any() and (seg >= n).any()
    got = ops.scatter_sum(torch.as_tensor(values), torch.as_tensor(seg), n)
    for want in (jax_ops.scatter_sum(jnp.asarray(values), jnp.asarray(seg),
                                     n),
                 jax_ref.scatter_sum(jnp.asarray(values), jnp.asarray(seg),
                                     n)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    small = torch.ones((4, 2))
    out = ops.scatter_sum(small, torch.tensor([0, -1, 5, 1]), 3)
    assert out.tolist() == [[1.0, 1.0], [1.0, 1.0], [0.0, 0.0]]


def test_non_finite_rows_stay_in_their_segment():
    """A NaN or inf row reaches its own segment only, as in
    ``jax.ops.segment_sum`` (the TPU one-hot product would spread it)."""
    e, n, d = 64, 10, 8
    values, seg = _inputs(e, n, d, 13)
    values[5] = np.nan
    values[9, 2] = np.inf
    got = ops.scatter_sum(torch.as_tensor(values), torch.as_tensor(seg), n)
    want = np.asarray(jax_ref.scatter_sum(jnp.asarray(values),
                                          jnp.asarray(seg), n))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5,
                               equal_nan=True)
    bad = {int(seg[5]), int(seg[9])}
    finite = [s for s in range(n) if s not in bad]
    assert torch.isfinite(got[finite]).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_sort_feeds_the_kernel_its_rows(dtype):
    """The wrapper's sort, summed through the permutation in the kernel's
    order, gives the plain version's result: stable order, masked and
    out-of-range rows at the sentinel and never read."""
    e, n, d = 300, 40, 6
    values, seg = _inputs(e, n, d, 14, ids=lambda rng: rng.integers(
        -5, n + 5, e).astype(np.int32))
    mask = torch.as_tensor(np.random.default_rng(15).random(e) < 0.8)
    tv = torch.as_tensor(values).to(dtype)
    sorted_ids, order = ops.sort_rows(torch.as_tensor(seg), n, mask)
    assert torch.equal(sorted_ids, torch.sort(sorted_ids, stable=True)[0])
    dropped = (torch.as_tensor(seg)[order] < 0) \
        | (torch.as_tensor(seg)[order] >= n) | ~mask[order]
    assert torch.equal(sorted_ids == n, dropped)
    for s in range(n):       # stable: each segment's rows in input order
        rows = order[sorted_ids == s]
        assert torch.equal(rows, torch.sort(rows)[0])
    got = _through_permutation(tv, torch.as_tensor(seg), n, mask)
    want = ref.scatter_sum(tv, torch.as_tensor(seg), n, mask)
    tol = 1e-6 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    values = torch.zeros((4, 2))
    seg = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.launch_kernel(values, *ops.sort_rows(seg, 3), 3)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.scatter_sum(values.to("meta"), seg.to("meta"), 3)
    with pytest.raises(ValueError, match="expected \\[E, D\\]"):
        ops.scatter_sum(torch.zeros(4), seg, 3)
    with pytest.raises(ValueError, match="segment_ids has shape"):
        ops.scatter_sum(values, seg[:3], 3)


def test_kernel_matches_plain_on_gpu():
    """B4 against its plain version on the card, on the JAX test shapes
    in both dtypes, with a mask and out-of-range ids; skips on a host
    without one (chip_smoke.py runs the same checks there)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py covers the kernel")
    for e, n, d in SHAPES:
        for _, tdt, rtol, atol in DTYPES.values():
            values, seg = _inputs(e, n, d, e + n + d, ids=lambda rng: (
                rng.integers(-3, n + 3, e).astype(np.int32)))
            mask = torch.as_tensor(np.random.default_rng(e).random(e) < 0.9,
                                   device="cuda")
            tv = torch.as_tensor(values, device="cuda").to(tdt)
            ts = torch.as_tensor(seg, device="cuda")
            got = ops.scatter_sum(tv, ts, n, mask)
            want = ref.scatter_sum(tv.float(), ts, n, mask)
            torch.testing.assert_close(got.float(), want, rtol=rtol,
                                       atol=atol)
