"""Phase-1 torch reference expansion against the JAX package's
``repro.core.expansion``, zone by zone (tolerance 0: int32 outputs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import expansion as j_expansion
from repro.core import tzp
from repro_torch.core import expansion
from conftest import random_graph
from torch_corpus import CASE_IDS, CASES, to_torch


def _jax_zones(batch, delta, l_max):
    res = j_expansion.scan_zones(
        *(jnp.asarray(x) for x in (batch.u, batch.v, batch.t, batch.valid)),
        delta=delta, l_max=l_max)
    return np.asarray(res.code), np.asarray(res.length)


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_scan_zones_matches_jax_per_bucket(case):
    _, make, (delta, l_max, omega) = case
    g = make()
    plan = tzp.plan_zones(g, delta=delta, l_max=l_max, omega=omega)
    layout = tzp.build_zone_layout(g, plan, layout="bucketed")
    assert layout.n_buckets >= 2
    for b in layout.buckets:
        res = expansion.scan_zones(*to_torch(b.u, b.v, b.t, b.valid),
                                   delta=delta, l_max=l_max)
        code, length = _jax_zones(b, delta, l_max)
        assert res.code.dtype == torch.int32
        np.testing.assert_array_equal(res.code.numpy(), code)
        np.testing.assert_array_equal(res.length.numpy(), length)


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_scan_zone_matches_jax_zone_by_zone(case):
    _, make, (delta, l_max, omega) = case
    g = make()
    plan = tzp.plan_zones(g, delta=delta, l_max=l_max, omega=omega)
    batch = tzp.build_zone_batch(g, plan)
    for z in range(batch.n_zones):
        res = expansion.scan_zone(
            *to_torch(batch.u[z], batch.v[z], batch.t[z], batch.valid[z]),
            delta=delta, l_max=l_max)
        j = j_expansion.scan_zone(
            *(jnp.asarray(x[z]) for x in (batch.u, batch.v, batch.t,
                                          batch.valid)),
            delta=delta, l_max=l_max)
        np.testing.assert_array_equal(res.code.numpy(), np.asarray(j.code))
        np.testing.assert_array_equal(res.length.numpy(),
                                      np.asarray(j.length))


def test_unsorted_rows_sweep_full_width():
    """Rows that are not time-sorted fall back to the full candidate
    width, so the outputs still equal the JAX expansion's."""
    rng = np.random.default_rng(4)
    u = rng.integers(0, 5, (3, 40)).astype(np.int32)
    v = rng.integers(0, 5, (3, 40)).astype(np.int32)
    t = rng.integers(0, 60, (3, 40)).astype(np.int32)        # unsorted
    valid = rng.random((3, 40)) < 0.8
    res = expansion.scan_zones(*to_torch(u, v, t, valid), delta=9, l_max=4)
    j = j_expansion.scan_zones(*(jnp.asarray(x) for x in (u, v, t, valid)),
                               delta=9, l_max=4)
    np.testing.assert_array_equal(res.code.numpy(), np.asarray(j.code))
    np.testing.assert_array_equal(res.length.numpy(), np.asarray(j.length))


def test_partial_validity_and_ties():
    g = random_graph(8, 160, 6, 50)           # ~3 edges per timestamp
    valid = np.random.default_rng(8).random(160) < 0.7
    args = (g.u, g.v, g.t, valid)
    res = expansion.scan_zone(*to_torch(*args), delta=4, l_max=5)
    j = j_expansion.scan_zone(*(jnp.asarray(x) for x in args), delta=4,
                              l_max=5)
    np.testing.assert_array_equal(res.code.numpy(), np.asarray(j.code))
    np.testing.assert_array_equal(res.length.numpy(), np.asarray(j.length))
    assert not res.length.numpy()[~valid].any()
