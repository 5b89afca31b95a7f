"""The segment scatter-sum (B4) of the port against the JAX package.

The plain version (``repro_torch.kernels.segment_spmm.ref.scatter_sum``,
what ``ops.scatter_sum`` runs on CPU tensors) is held against the JAX
wrapper ``ops.scatter_sum`` (the Pallas kernel in interpret mode, as the
JAX tests run it) and against the JAX oracle ``ref.scatter_sum``
(``jax.ops.segment_sum``).  Tolerances are the JAX tests': 1e-5 for f32
(both sum each segment's rows in fp32, in another order), and for bf16
2e-2 relative / 0.15 absolute against the fp32 oracle (the bf16 inputs and
the rounding of the sums on the way out).  The CUDA kernel runs on the
card only (``chip_smoke.py``); here its wrapper's segment plan (sort,
sentinel, offsets) is held against the JAX wrapper's ``jnp.argsort`` and
checked by summing through the permutation on the CPU, and the row-indexed
sum that fuses the ``h[src]`` gather is held against the JAX wrapper on
the materialised ``h[src]``.
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
    """What the kernel computes from the wrapper's plan, summed on the CPU
    row by row: each segment's sorted positions, read through the
    permutation."""
    plan = ops.plan(seg, n, mask)
    assert plan.sorted_ids.dtype == torch.int32
    assert plan.order.dtype == torch.int32
    assert plan.offsets.dtype == torch.int64
    out = torch.zeros((n, values.shape[1]), dtype=torch.float32)
    for s in range(n):
        for r in range(int(plan.offsets[s]), int(plan.offsets[s + 1])):
            out[s] += values[plan.order[r]].float()
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
    plan = ops.plan(torch.as_tensor(seg), n, mask)
    sorted_ids, order = plan.sorted_ids, plan.order.long()
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
    plan = ops.plan(seg, 3)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.launch_kernel(values, plan, plan.order)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.plan(seg.to("meta"), 3)
    with pytest.raises(ValueError, match="rows has shape"):
        ops.segment_sum(values, plan, plan.order[:3])
    with pytest.raises(ValueError, match="index has shape"):
        plan.compose(seg[:3])
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


def _graph(n, e, d, seed, hot=False):
    """Node rows ``h``, edges ``src -> dst`` with a mask, out-of-range and
    negative destinations (and, with ``hot``, 80% of them on one node)."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((n, d)).astype(np.float32)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(-4, n + 4, e).astype(np.int32)
    if hot:
        dst = np.where(rng.random(e) < 0.8, 1, dst).astype(np.int32)
    mask = rng.random(e) < 0.85
    return h, src, dst, mask


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("e,n", [(300, 40), (2048, 64), (1, 3), (0, 5)])
def test_plan_matches_jax_wrapper_sort(e, n, with_mask):
    """The plan's sorted ids and permutation are the JAX wrapper's kept ids
    (masked rows to the sentinel ``n``) in ``jnp.argsort`` order, over the
    rows ``jax.ops.segment_sum`` keeps; every dropped row (masked, out of
    range, negative) sorts last at the sentinel, in input order; the
    offsets are the first sorted position of each segment."""
    _, _, dst, mask = _graph(max(n, 1), e, 2, e + n)
    mask = mask if with_mask else None
    plan = ops.plan(torch.as_tensor(dst), n,
                    None if mask is None else torch.as_tensor(mask))
    jids = jnp.asarray(dst)
    if mask is not None:
        jids = jnp.where(jnp.asarray(mask), jids, n)   # the JAX wrapper
    jorder = np.asarray(jnp.argsort(jids))
    jsorted = np.asarray(jids)[jorder]
    kept = (jsorted >= 0) & (jsorted < n)
    n_kept = int(kept.sum())
    assert np.array_equal(plan.sorted_ids[:n_kept].numpy(), jsorted[kept])
    assert np.array_equal(plan.order[:n_kept].numpy(), jorder[kept])
    assert (plan.sorted_ids[n_kept:] == n).all()
    assert np.array_equal(plan.order[n_kept:].numpy(), np.sort(jorder[~kept]))
    # in full: jnp.argsort of the ids with every dropped row at n
    dropped = (dst < 0) | (dst >= n)
    if mask is not None:
        dropped |= ~mask
    full = np.asarray(jnp.argsort(jnp.where(jnp.asarray(dropped), n, dst)))
    assert np.array_equal(plan.order.numpy(), full)
    assert np.array_equal(plan.offsets.numpy(), np.searchsorted(
        plan.sorted_ids.numpy(), np.arange(n + 1)))


@pytest.mark.parametrize("hot", [False, True])
@pytest.mark.parametrize("n,e,d", [(40, 300, 8), (128, 1000, 64),
                                   (300, 513, 70), (64, 2048, 128)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rows_indexed_sum_matches_jax_gather_and_sum(n, e, d, dtype, hot):
    """The gather fused into the sum: rows ``plan.compose(src)`` of ``h``
    give JAX ``ops.scatter_sum(h[src], dst, n, mask)`` (interpret mode)
    and ``jax.ops.segment_sum``, at the JAX tests' tolerances (1e-4 for
    f32 with a hot segment), and bitwise the sum over the materialised
    ``h[src]`` with ``rows = order``."""
    jdt, tdt, rtol, atol = DTYPES[dtype]
    if hot and dtype == "float32":
        rtol = atol = 1e-4
    h, src, dst, mask = _graph(n, e, d, n + e + d, hot=hot)
    th = torch.as_tensor(h).to(tdt)
    plan = ops.plan(torch.as_tensor(dst), n, torch.as_tensor(mask))
    got = ops.segment_sum(th, plan, plan.compose(torch.as_tensor(src)))
    assert got.dtype == tdt and got.shape == (n, d)
    assert torch.equal(got, ops.segment_sum(th[torch.as_tensor(src).long()],
                                            plan))
    jh = jnp.asarray(h, jdt)[jnp.asarray(src)]
    for want in (jax_ops.scatter_sum(jh, jnp.asarray(dst), n,
                                     jnp.asarray(mask)),
                 jax_ref.scatter_sum(jh.astype(jnp.float32), jnp.asarray(dst),
                                     n, jnp.asarray(mask))):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=rtol,
                                   atol=atol)


def test_plans_and_launches_are_counted():
    """A plan build counts once on any device; the CPU never counts a
    kernel launch; ``scatter_sum`` builds its own plan."""
    ops.reset_launches()
    values = torch.ones((6, 3))
    seg = torch.tensor([0, 2, 2, 1, 5, 0])
    plan = ops.plan(seg, 3)
    for _ in range(3):
        ops.segment_sum(values, plan)
    assert ops.plans == {"segment_plan": 1, "segment_plan_backward": 0}
    assert ops.scatter_sum(values, seg, 3).tolist() == [[2.0] * 3, [1.0] * 3,
                                                        [2.0] * 3]
    assert ops.plans == {"segment_plan": 2, "segment_plan_backward": 0}
    assert ops.launches == {"segment_spmm": 0, "segment_spmm_backward": 0}
    ops.reset_launches()
    assert ops.plans == {"segment_plan": 0, "segment_plan_backward": 0}


def test_kernel_fused_rows_and_hot_segment_on_gpu():
    """On the card: the fused row index gives bitwise the ``rows = order``
    result on the materialised ``h[src]``, each launch gives bitwise the
    same output, a hot segment split into chunks equals the plain version
    (f32 1e-4), and one plan serves every launch; skips on a host without
    one (chip_smoke.py runs the same checks at full size)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py covers the kernel")
    for n, e, d in ((64, 5000, 64), (300, 4000, 70), (40, 3000, 16)):
        for _, tdt, rtol, atol in DTYPES.values():
            h, src, dst, mask = _graph(n, e, d, n + e, hot=True)
            th = torch.as_tensor(h, device="cuda").to(tdt)
            tsrc = torch.as_tensor(src, device="cuda")
            plan = ops.plan(torch.as_tensor(dst, device="cuda"), n,
                            torch.as_tensor(mask, device="cuda"))
            fused = ops.segment_sum(th, plan, plan.compose(tsrc))
            again = ops.segment_sum(th, plan, plan.compose(tsrc))
            msgs = th[tsrc.long()]
            assert torch.equal(fused, again)
            assert torch.equal(fused, ops.segment_sum(msgs, plan))
            for chunk in (1, 7, 1 << 30):   # every segment split, none
                got = ops.launch_kernel(msgs, plan, plan.order, chunk=chunk)
                want = ref.scatter_sum(msgs.float(), torch.as_tensor(
                    dst, device="cuda"), n, torch.as_tensor(
                        mask, device="cuda"))
                tol = (1e-4, 1e-4) if tdt == torch.float32 else (rtol, atol)
                torch.testing.assert_close(got.float(), want.float(),
                                           rtol=tol[0], atol=tol[1])
