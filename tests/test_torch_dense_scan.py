"""The dense per-zone scan and every ``with_ts`` scan of the port against
the JAX package, slot for slot (tolerance 0: every output is int32).

``expansion.scan_zones`` is the plain version of the dense CUDA kernel
(both variants), ``ref.fused_zone_scan_torch(with_ts=True)`` the plain
version of the flat kernel's ``with_ts`` variant; ``scan_numpy`` is the
host oracle; ``derive_lengths`` the co-mining truncation."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import expansion as j_expansion
from repro.core import scan_numpy as j_scan_numpy
from repro.core import tzp
from repro.kernels.zone_scan import ops as jax_ops
from repro.kernels.zone_scan.xla import scan_flat_xla
from repro_torch.core import expansion, scan_numpy
from repro_torch.kernels.zone_scan import ops, ref
from conftest import random_graph
from torch_corpus import CASE_IDS, CASES, to_torch


def _layout(case):
    _, make, (delta, l_max, omega) = case
    g = make()
    plan = tzp.plan_zones(g, delta=delta, l_max=l_max, omega=omega)
    return tzp.build_zone_layout(g, plan, layout="bucketed"), delta, l_max


def _jax_scan(arrays, delta, l_max, with_ts=True):
    res = j_expansion.scan_zones(*(jnp.asarray(x) for x in arrays),
                                 delta=delta, l_max=l_max, with_ts=with_ts)
    return [np.asarray(x) for x in res]


def _assert_equal(outs, expect):
    assert len(outs) == len(expect)
    for a, b in zip(outs, expect):
        a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_scan_zones_with_ts_matches_jax(case):
    layout, delta, l_max = _layout(case)
    assert layout.n_buckets >= 2
    for b in layout.buckets:
        arrays = (b.u, b.v, b.t, b.valid)
        res = expansion.scan_zones(*to_torch(*arrays), delta=delta,
                                   l_max=l_max, with_ts=True)
        _assert_equal(res, _jax_scan(arrays, delta, l_max))
        plain = expansion.scan_zones(*to_torch(*arrays), delta=delta,
                                     l_max=l_max)
        assert plain.ts is None
        assert torch.equal(plain.code, res.code)
        assert torch.equal(plain.length, res.length)


def test_scan_zone_with_ts_partial_validity_and_ties():
    g = random_graph(8, 160, 6, 50)           # ~3 edges per timestamp
    valid = np.random.default_rng(8).random(160) < 0.7
    arrays = (g.u, g.v, g.t, valid)
    res = expansion.scan_zone(*to_torch(*arrays), delta=4, l_max=5,
                              with_ts=True)
    j = j_expansion.scan_zone(*(jnp.asarray(x) for x in arrays), delta=4,
                              l_max=5, with_ts=True)
    _assert_equal(res, [np.asarray(x) for x in j])
    assert not res.ts.numpy()[~valid].any()


def test_unsorted_rows_with_ts_match_jax():
    """Rows that are not time-sorted sweep the full width, ts included."""
    rng = np.random.default_rng(4)
    u = rng.integers(0, 5, (3, 40)).astype(np.int32)
    v = rng.integers(0, 5, (3, 40)).astype(np.int32)
    t = rng.integers(0, 60, (3, 40)).astype(np.int32)        # unsorted
    valid = rng.random((3, 40)) < 0.8
    res = expansion.scan_zones(*to_torch(u, v, t, valid), delta=9, l_max=4,
                               with_ts=True)
    _assert_equal(res, _jax_scan((u, v, t, valid), 9, 4))


def _flat(case, bounds, blk=512):
    layout, delta, l_max = _layout(case)
    fl = tzp.concat_layout(layout, blk=blk, delta=delta, l_max=l_max,
                           bounds=bounds)
    return fl, (fl.u, fl.v, fl.t, fl.valid, fl.zone_id, fl.lo, fl.hi), \
        delta, l_max


@pytest.mark.parametrize("bounds", ["full", "live"])
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_fused_plain_with_ts_matches_xla(case, bounds):
    fl, arrays, delta, l_max = _flat(case, bounds)
    out = ref.fused_zone_scan_torch(*to_torch(*arrays), delta=delta,
                                    l_max=l_max, blk=fl.blk, with_ts=True)
    j = scan_flat_xla(*(jnp.asarray(a) for a in arrays), delta=delta,
                      l_max=l_max, blk=fl.blk, with_ts=True)
    _assert_equal(out, [np.asarray(x) for x in j])
    assert out[2].shape == (fl.n_slots, l_max)


@pytest.mark.parametrize("bounds", ["full", "live"])
@pytest.mark.parametrize("case", CASES[:3], ids=CASE_IDS[:3])
def test_fused_plain_with_ts_matches_pallas_interpret(case, bounds):
    """The TPU kernel's with_ts variant itself, by the Pallas
    interpreter."""
    fl, arrays, delta, l_max = _flat(case, bounds, blk=256)
    out = ref.fused_zone_scan_torch(*to_torch(*arrays), delta=delta,
                                    l_max=l_max, blk=fl.blk, with_ts=True)
    p = jax_ops.scan_flat(*(jnp.asarray(a) for a in arrays), delta=delta,
                          l_max=l_max, blk=fl.blk, interpret=True,
                          with_ts=True)
    _assert_equal(out, [np.asarray(x) for x in p])


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_retired_lanes_keep_their_timestamps(case):
    """The plain flat scan retires finished lanes every few steps; their
    timestamps must equal the unmasked sweep's."""
    fl, arrays, delta, l_max = _flat(case, "live")
    early = ref.fused_zone_scan_torch(*to_torch(*arrays), delta=delta,
                                      l_max=l_max, blk=fl.blk, with_ts=True)
    full = ref.fused_zone_scan_torch(*to_torch(*arrays), delta=delta,
                                     l_max=l_max, blk=fl.blk, with_ts=True,
                                     early_exit=False)
    for a, b in zip(early, full):
        assert torch.equal(a, b)
    # the with_ts sweep leaves code and length as the plain sweep has them
    code, length = ref.fused_zone_scan_torch(
        *to_torch(*arrays), delta=delta, l_max=l_max, blk=fl.blk)
    assert torch.equal(code, early[0]) and torch.equal(length, early[1])


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_derive_lengths_matches_jax(case):
    """Every smaller (delta, l_max), down to (1, 1), on every bucket —
    including the length-0 rows of invalid slots."""
    layout, delta, l_max = _layout(case)
    for b in layout.buckets:
        arrays = (b.u, b.v, b.t, b.valid)
        res = expansion.scan_zones(*to_torch(*arrays), delta=delta,
                                   l_max=l_max, with_ts=True)
        _, j_len, j_ts = _jax_scan(arrays, delta, l_max)
        assert (res.length == 0).any()
        for d_i in sorted({1, max(1, delta // 3), delta}):
            for l_i in range(1, l_max + 1):
                got = expansion.derive_lengths(res.length, res.ts, delta=d_i,
                                               l_max=l_i)
                want = j_expansion.derive_lengths(
                    jnp.asarray(j_len), jnp.asarray(j_ts), delta=d_i,
                    l_max=l_i)
                _assert_equal([got], [np.asarray(want)])


def test_derive_lengths_single_step_dominating_sweep():
    """``l_max_dom == 1``: there are no gaps; a process keeps one edge."""
    length = torch.tensor([0, 1, 1, 0], dtype=torch.int32)
    ts = torch.tensor([[0], [5], [9], [0]], dtype=torch.int32)
    got = expansion.derive_lengths(length, ts, delta=3, l_max=1)
    want = j_expansion.derive_lengths(jnp.asarray(length.numpy()),
                                      jnp.asarray(ts.numpy()), delta=3,
                                      l_max=1)
    _assert_equal([got], [np.asarray(want)])
    assert got.tolist() == [0, 1, 1, 0]


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_scan_numpy_matches_jax(case):
    layout, delta, l_max = _layout(case)
    b = layout.buckets[0]
    arrays = (b.u, b.v, b.t, b.valid)
    for with_ts in (False, True):
        got = scan_numpy.scan_zones(*arrays, delta=delta, l_max=l_max,
                                    with_ts=with_ts)
        want = j_scan_numpy.scan_zones(*arrays, delta=delta, l_max=l_max,
                                       with_ts=with_ts)
        assert (got.ts is None) == (not with_ts)
        _assert_equal([x for x in got if x is not None],
                      [x for x in want if x is not None])


def test_dense_wrapper_runs_plain_version_on_cpu_tensors():
    layout, delta, l_max = _layout(CASES[1])
    b = layout.buckets[-1]
    ops.reset_launches()
    for with_ts in (False, True):
        res = ops.scan_zones(*to_torch(b.u, b.v, b.t, b.valid), delta=delta,
                             l_max=l_max, with_ts=with_ts)
        want = expansion.scan_zones(*to_torch(b.u, b.v, b.t, b.valid),
                                    delta=delta, l_max=l_max,
                                    with_ts=with_ts)
        for a, w in zip(res, want):
            assert (a is None and w is None) or torch.equal(a, w)
    assert not any(ops.launches.values())    # counts are of kernel launches
    assert set(ops.launches) == set(ops.VARIANTS)


def test_dense_kernel_launch_refuses_cpu_tensors_and_bad_shapes():
    layout, delta, l_max = _layout(CASES[0])
    b = layout.buckets[0]
    args = to_torch(b.u, b.v, b.t, b.valid)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.launch_zone_kernel(*args, delta=delta, l_max=l_max)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.launch_kernel(*to_torch(*_flat(CASES[0], "live")[1]),
                          delta=delta, l_max=l_max, with_ts=True)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.scan_zones(*(x.to("meta") for x in args), delta=delta,
                       l_max=l_max)


def test_dense_kernel_matches_plain_on_gpu():
    """Both dense variants and the flat with_ts variant against their
    plain versions on the card; skips on a host without one
    (chip_smoke.py runs the same checks there)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py covers the kernels")
    for case in CASES:
        layout, delta, l_max = _layout(case)
        for b in layout.buckets:
            args = [x.cuda() for x in to_torch(b.u, b.v, b.t, b.valid)]
            for with_ts in (False, True):
                got = ops.launch_zone_kernel(*args, delta=delta,
                                             l_max=l_max, with_ts=with_ts)
                want = expansion.scan_zones(*args, delta=delta, l_max=l_max,
                                            with_ts=with_ts)
                for a, w in zip(got, want):
                    assert (a is None and w is None) or torch.equal(a, w)
        fl, arrays, _, _ = _flat(case, "live")
        args = [x.cuda() for x in to_torch(*arrays)]
        got = ops.launch_kernel(*args, delta=delta, l_max=l_max,
                                blk=fl.blk, with_ts=True)
        want = ref.fused_zone_scan_torch(*args, delta=delta, l_max=l_max,
                                         blk=fl.blk, with_ts=True)
        assert all(torch.equal(a, w) for a, w in zip(got, want))
