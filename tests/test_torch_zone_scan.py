"""Fused flat zone scan: the port's plain version and kernel wrapper
against the JAX package's lowerings, slot for slot (tolerance 0: every
output is int32)."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tzp
from repro.kernels.zone_scan import ops as jax_ops
from repro.kernels.zone_scan import ref as jax_ref
from repro.kernels.zone_scan.xla import fused_zone_scan_xla
from repro_torch.core import encoding as t_encoding
from repro_torch.core import planner as t_planner
from repro_torch.kernels.zone_scan import ops, ref
from torch_corpus import CASE_IDS, CASES, to_torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402  (the flat adversarial layout of the card run)

#: the flat kernel's solo slots (kSoloSlots) and its adversarial layout at
#: a small size: rows of 520 slots, blocks of 256
SOLO = chip_smoke.SOLO_SLOTS
ADV_DELTA = 1000


def _flat(case, bounds, blk=512):
    _, make, (delta, l_max, omega) = case
    g = make()
    plan = tzp.plan_zones(g, delta=delta, l_max=l_max, omega=omega)
    lay = tzp.build_zone_layout(g, plan)
    fl = tzp.concat_layout(lay, blk=blk, delta=delta, l_max=l_max,
                           bounds=bounds)
    return fl, delta, l_max


def _arrays(fl):
    return (fl.u, fl.v, fl.t, fl.valid, fl.zone_id, fl.lo, fl.hi)


def _plain(fl, delta, l_max, **kw):
    code, length = ref.fused_zone_scan_torch(
        *to_torch(*_arrays(fl)), delta=delta, l_max=l_max, blk=fl.blk, **kw)
    return code.numpy(), length.numpy()


@pytest.mark.parametrize("bounds", ["full", "live"])
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_plain_matches_xla_lowering(case, bounds):
    fl, delta, l_max = _flat(case, bounds)
    code, length = _plain(fl, delta, l_max)
    j_code, j_len = fused_zone_scan_xla(
        *(jnp.asarray(a) for a in _arrays(fl)), delta=delta, l_max=l_max,
        blk=fl.blk)
    assert code.dtype == np.int32 and length.dtype == np.int32
    np.testing.assert_array_equal(code, np.asarray(j_code))
    np.testing.assert_array_equal(length, np.asarray(j_len))
    assert code.shape == (fl.n_slots, t_encoding.n_limbs(l_max))


@pytest.mark.parametrize("bounds", ["full", "live"])
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_plain_matches_per_zone_reference(case, bounds):
    fl, delta, l_max = _flat(case, bounds)
    code, length = _plain(fl, delta, l_max)
    a = jax_ref.scan_flat_ref(fl.u, fl.v, fl.t, fl.valid, fl.zone_id,
                              delta=delta, l_max=l_max)
    np.testing.assert_array_equal(code, a.code)
    np.testing.assert_array_equal(length, a.length)


@pytest.mark.parametrize("bounds", ["full", "live"])
@pytest.mark.parametrize("case", CASES[:3], ids=CASE_IDS[:3])
def test_plain_matches_pallas_interpret(case, bounds):
    """Small S: the TPU kernel itself, run by the Pallas interpreter."""
    fl, delta, l_max = _flat(case, bounds, blk=256)
    code, length = _plain(fl, delta, l_max)
    p_code, p_len = jax_ops.scan_flat(
        *(jnp.asarray(a) for a in _arrays(fl)), delta=delta, l_max=l_max,
        blk=fl.blk, interpret=True)
    np.testing.assert_array_equal(code, np.asarray(p_code))
    np.testing.assert_array_equal(length, np.asarray(p_len))


@pytest.mark.parametrize("bounds", ["full", "live"])
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_early_exit_rule_is_exact(case, bounds):
    """A lane that timed out or holds l_max edges ignores every later
    edge (the kernel's per-lane early exit): outputs are unchanged."""
    fl, delta, l_max = _flat(case, bounds)
    full = _plain(fl, delta, l_max, early_exit=False)
    early = _plain(fl, delta, l_max, early_exit=True)
    np.testing.assert_array_equal(full[0], early[0])
    np.testing.assert_array_equal(full[1], early[1])


def test_live_steps_within_window_model():
    """The early-exit sweep visits at least one slot per seeded lane and
    never more than the block-window model dispatches."""
    fl, delta, l_max = _flat(CASES[0], "live")
    steps = ref.live_steps(*to_torch(*_arrays(fl)), delta=delta,
                           l_max=l_max, blk=fl.blk)
    _, length = _plain(fl, delta, l_max)
    assert (length > 0).sum() <= steps
    assert steps <= t_planner.fused_sweep_slots(fl.lo, fl.hi, fl.blk)


def test_wrapper_runs_plain_version_on_cpu_tensors():
    fl, delta, l_max = _flat(CASES[1], "live")
    ops.reset_launches()
    code, length = ops.scan_flat(*to_torch(*_arrays(fl)), delta=delta,
                                 l_max=l_max, blk=fl.blk)
    expect = _plain(fl, delta, l_max)
    np.testing.assert_array_equal(code.numpy(), expect[0])
    np.testing.assert_array_equal(length.numpy(), expect[1])
    # the counts are of kernel launches
    assert ops.launches["fused_zone_scan_flat"] == 0


def test_all_pad_stream_yields_zero_lengths():
    s = 128
    zeros = torch.zeros(s, dtype=torch.int32)
    code, length = ops.scan_flat(
        zeros, zeros, zeros, zeros, torch.full((s,), -1, dtype=torch.int32),
        torch.tensor([0], dtype=torch.int32),
        torch.tensor([s], dtype=torch.int32), delta=5, l_max=3, blk=128)
    assert not length.any() and not code.any()


def test_kernel_launch_refuses_cpu_tensors_and_bad_shapes():
    fl, delta, l_max = _flat(CASES[0], "live")
    args = to_torch(*_arrays(fl))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.launch_kernel(*args, delta=delta, l_max=l_max, blk=fl.blk)
    with pytest.raises(ValueError, match="multiple of blk"):
        ref.fused_zone_scan_torch(*args, delta=delta, l_max=l_max, blk=300)
    with pytest.raises(ValueError, match="descriptors"):
        ref.fused_zone_scan_torch(*args[:5], args[5][:1], args[6],
                                  delta=delta, l_max=l_max, blk=fl.blk)
    with pytest.raises(ValueError, match="l_max=15"):
        ref.fused_zone_scan_torch(*args, delta=delta, l_max=15, blk=fl.blk)


def test_kernel_matches_plain_on_gpu():
    """The CUDA kernel against its plain version on the card; skips on a
    host without one (chip_smoke.py runs the same check there)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py covers the kernel")
    for case in CASES:
        for bounds in ("full", "live"):
            fl, delta, l_max = _flat(case, bounds)
            args = [x.cuda() for x in to_torch(*_arrays(fl))]
            code, length = ops.launch_kernel(*args, delta=delta,
                                             l_max=l_max, blk=fl.blk)
            p_code, p_len = ref.fused_zone_scan_torch(
                *args, delta=delta, l_max=l_max, blk=fl.blk)
            assert torch.equal(code, p_code) and torch.equal(length, p_len)


def _adversarial():
    return chip_smoke.adversarial_flat(SOLO, e_cap=520, blk=256)


def test_adversarial_flat_layout_has_its_cases():
    """Zone ends inside warps and at the solo/cooperative boundary, a row
    ending on the stream pad inside a warp, and a block whose hi cuts a
    row: the cases the flat kernel's row ends must meet."""
    fl = _adversarial()
    zid = fl.zone_id
    starts = np.flatnonzero(np.diff(zid) != 0) + 1      # first slot of a row
    assert (starts % 32 != 0).sum() > 10                 # ends inside warps
    lengths = np.diff(np.concatenate([[0], starts]))
    for n in (SOLO, SOLO + 1, SOLO + 2):                 # lane 0 meets its end
        assert (lengths == n).any()                      # at W, W+1, W+2
    warps = zid[:(zid.size // 32) * 32].reshape(-1, 32)
    assert (np.array([np.unique(w).size for w in warps]) >= 3).any()
    n_real = int((zid >= 0).sum())
    assert zid[n_real:].size and (zid[n_real:] == -1).all()
    assert not fl.valid[n_real:].any() and n_real % 32 != 0
    # a live block whose window ends inside a row of its own lanes
    cut = [i for i, (lo, hi) in enumerate(zip(fl.lo, fl.hi))
           if lo < hi < n_real and hi == lo + fl.blk
           and zid[hi - 1] == zid[hi]]
    assert cut, "no block's hi cuts a row"


def _adv_args(fl):
    return to_torch(*_arrays(fl))


@pytest.mark.parametrize("with_ts", [False, True])
@pytest.mark.parametrize("l_max", [6, 3])
def test_plain_matches_xla_on_adversarial_flat(l_max, with_ts):
    fl = _adversarial()
    got = ref.fused_zone_scan_torch(*_adv_args(fl), delta=ADV_DELTA,
                                    l_max=l_max, blk=fl.blk, with_ts=with_ts)
    want = fused_zone_scan_xla(*(jnp.asarray(a) for a in _arrays(fl)),
                               delta=ADV_DELTA, l_max=l_max, blk=fl.blk,
                               with_ts=with_ts)
    assert len(got) == len(want) == (3 if with_ts else 2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[1].numpy() > 1).sum() > 100     # lanes that extend


@pytest.mark.parametrize("with_ts", [False, True])
def test_plain_matches_pallas_interpret_on_adversarial_flat(with_ts):
    """The TPU kernel itself, run by the Pallas interpreter."""
    fl = _adversarial()
    got = ref.fused_zone_scan_torch(*_adv_args(fl), delta=ADV_DELTA,
                                    l_max=6, blk=fl.blk, with_ts=with_ts)
    want = jax_ops.scan_flat(*(jnp.asarray(a) for a in _arrays(fl)),
                             delta=ADV_DELTA, l_max=6, blk=fl.blk,
                             interpret=True, with_ts=with_ts)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_kernel_matches_plain_on_adversarial_flat_on_gpu():
    """The CUDA kernel's row ends against its plain version on the card;
    skips on a host without one (chip_smoke.py runs the same check at
    rows of 2,600 slots)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py covers the kernel")
    fl = _adversarial()
    args = [x.cuda() for x in _adv_args(fl)]
    for l_max in (6, 3):
        for with_ts in (False, True):
            got = ops.launch_kernel(*args, delta=ADV_DELTA, l_max=l_max,
                                    blk=fl.blk, with_ts=with_ts)
            want = ref.fused_zone_scan_torch(*args, delta=ADV_DELTA,
                                             l_max=l_max, blk=fl.blk,
                                             with_ts=with_ts)
            assert all(torch.equal(g, w) for g, w in zip(got, want))
