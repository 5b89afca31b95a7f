"""Host data model of the PyTorch port against the JAX package: zone
plans, fused layouts, the brute-force oracle, encoding, configs and the
cross-package converters (exact equality throughout)."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import MiningConfig as JaxConfig
from repro.core import encoding as j_encoding
from repro.core import oracle as j_oracle
from repro.core import transitions as j_transitions
from repro.core import tzp as j_tzp
from repro.data import synthetic_graphs as j_graphs
from repro_torch.core import MiningConfig, convert
from repro_torch.core import encoding as t_encoding
from repro_torch.core import oracle as t_oracle
from repro_torch.core import transitions as t_transitions
from repro_torch.core import tzp as t_tzp
from repro_torch.data import synthetic_graphs as t_graphs
from conftest import random_graph
from torch_corpus import CASE_IDS, CASES, powerlaw_bursty

_LAYOUT_ARRAYS = ("u", "v", "t", "valid", "zone_id", "sign", "lo", "hi")


def _port_graph(g):
    return convert.graph_from_arrays(g.u, g.v, g.t)


@pytest.mark.parametrize("e_cap", [None, 24])
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_plan_zones_json_equal(case, e_cap):
    _, make, (delta, l_max, omega) = case
    g = make()
    j = j_tzp.plan_zones(g, delta=delta, l_max=l_max, omega=omega,
                         e_cap=e_cap)
    t = t_tzp.plan_zones(_port_graph(g), delta=delta, l_max=l_max,
                         omega=omega, e_cap=e_cap)
    assert t.to_json() == j.to_json()
    assert t_tzp.ZonePlan.from_json(j.to_json()) == t
    assert t_tzp.graph_fingerprint(_port_graph(g)) == \
        j_tzp.graph_fingerprint(g)


@pytest.mark.parametrize("layout", ["auto", "dense", "bucketed"])
@pytest.mark.parametrize("bounds", ["full", "live"])
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_fused_layout_arrays_equal(case, bounds, layout):
    _, make, (delta, l_max, omega) = case
    g = make()
    tg = _port_graph(g)
    jp = j_tzp.plan_zones(g, delta=delta, l_max=l_max, omega=omega)
    tp = t_tzp.plan_zones(tg, delta=delta, l_max=l_max, omega=omega)
    jl = j_tzp.build_zone_layout(g, jp, layout=layout)
    tl = t_tzp.build_zone_layout(tg, tp, layout=layout)
    assert tl.bucket_shapes() == jl.bucket_shapes()
    assert tl.summary() == jl.summary()
    jf = j_tzp.concat_layout(jl, blk=256, pad_slots_to=512, delta=delta,
                             l_max=l_max, bounds=bounds)
    tf = t_tzp.concat_layout(tl, blk=256, pad_slots_to=512, delta=delta,
                             l_max=l_max, bounds=bounds)
    for name in _LAYOUT_ARRAYS:
        a, b = getattr(tf, name), getattr(jf, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert tf.summary() == jf.summary()
    # the converter rebuilds the same layout from the JAX package's arrays
    back = convert.fused_layout_from_arrays(
        blk=jf.blk, kind=jf.kind, bucket_shapes=jf.bucket_shapes,
        n_zones=jf.n_zones, overflow=jf.overflow, bounds=jf.bounds,
        **{k: getattr(jf, k) for k in _LAYOUT_ARRAYS})
    assert back.summary() == tf.summary()
    for name in _LAYOUT_ARRAYS:
        np.testing.assert_array_equal(getattr(back, name),
                                      getattr(tf, name))


def test_single_zone_plan_and_batch_equal():
    g = powerlaw_bursty(7)
    j = j_tzp.single_zone_plan(g, l_b=36)
    t = t_tzp.single_zone_plan(_port_graph(g), l_b=36)
    assert t.to_json() == j.to_json()
    jb = j_tzp.build_zone_batch(g, j, pad_zones_to=4)
    tb = t_tzp.build_zone_batch(_port_graph(g), t, pad_zones_to=4)
    for f in ("u", "v", "t", "valid", "sign", "perm"):
        np.testing.assert_array_equal(getattr(tb, f), getattr(jb, f))
    assert tb.overflow == jb.overflow


@pytest.mark.parametrize("delta,l_max", [(12, 3), (30, 7), (5, 1)])
def test_oracle_counts_equal(delta, l_max):
    g = random_graph(3, 300, 12, 900)
    assert t_oracle.count_codes(g.u, g.v, g.t, delta, l_max) == \
        j_oracle.count_codes(g.u, g.v, g.t, delta, l_max)


def test_synthetic_generators_equal():
    for name in ("poisson_stream", "powerlaw_stream", "bursty_stream",
                 "triadic_stream"):
        j = getattr(j_graphs, name)(500, 40, seed=2)
        t = getattr(t_graphs, name)(500, 40, seed=2)
        for f in ("u", "v", "t"):
            np.testing.assert_array_equal(getattr(t, f), getattr(j, f))
    assert sorted(t_graphs.DATASET_ANALOGS) == sorted(j_graphs.DATASET_ANALOGS)


@pytest.mark.parametrize("l_max", [1, 3, 7, 14])
def test_encoding_torch_twins_equal(l_max):
    rng = np.random.default_rng(l_max)
    limbs = t_encoding.n_limbs(l_max)
    assert limbs == j_encoding.n_limbs(l_max)
    code = np.zeros((6, 5, limbs), np.int32)
    lengths = rng.integers(0, l_max + 1, (6, 5)).astype(np.int32)
    t_code, j_code = torch.as_tensor(code), jnp.asarray(code)
    for pos in range(2 * l_max):
        digit = rng.integers(1, 16, (6, 5)).astype(np.int32)
        p = np.full((6, 5), pos, np.int32)
        t_code = t_encoding.append_digit(t_code, torch.as_tensor(p),
                                         torch.as_tensor(digit))
        j_code = j_encoding.append_digit(j_code, jnp.asarray(p),
                                         jnp.asarray(digit))
    np.testing.assert_array_equal(t_code.numpy(), np.asarray(j_code))
    np.testing.assert_array_equal(
        t_encoding.truncate_codes(t_code, torch.as_tensor(lengths)).numpy(),
        np.asarray(j_encoding.truncate_codes(j_code, jnp.asarray(lengths))))
    assert tuple(t_encoding.empty_code((2, 3), l_max).shape) == \
        j_encoding.empty_code((2, 3), l_max).shape
    row = t_code.numpy()[0, 0]
    assert t_encoding.decode_code_np(row) == j_encoding.decode_code_np(row)


def test_counts_to_dict_equal():
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 1 << 20, (40, 2)).astype(np.int32)
    counts = rng.integers(-2, 4, 40).astype(np.int32)
    mask = rng.random(40) < 0.7
    assert t_transitions.counts_to_dict(codes, counts, mask) == \
        j_transitions.counts_to_dict(codes, counts, mask)


def test_config_json_round_trips_between_packages():
    j = JaxConfig(delta=300, l_max=5, omega=7, e_cap=4096, zone_chunk=2,
                  agg="legacy", merge_cap=512, allow_overflow=True,
                  zone_layout="bucketed", fused="on")
    t = MiningConfig.from_json(j.to_json())
    assert t.to_json() == j.to_json()
    assert JaxConfig.from_json(t.to_json()) == j
    assert MiningConfig().to_json() == JaxConfig().to_json()
    assert [f.name for f in dataclasses.fields(MiningConfig)] == \
        [f.name for f in dataclasses.fields(JaxConfig)]


def test_config_from_json_maps_registry_names():
    j = JaxConfig(backend="pallas", fused_backend="xla", delta=60)
    t = convert.config_from_json(j.to_json())
    assert (t.backend, t.fused_backend, t.delta) == ("cuda", "torch", 60)
    with pytest.raises(ValueError, match="unknown backend 'pallas'"):
        MiningConfig.from_json(j.to_json())
    # every JAX registry name has a counterpart: numpy carries over as is
    t = convert.config_from_json(JaxConfig(backend="numpy").to_json())
    assert t.backend == "numpy"
    bad = json.loads(JaxConfig().to_json())
    bad["backend"] = "tpu"
    with pytest.raises(ValueError, match="unknown backend 'tpu'"):
        convert.config_from_json(bad)


def test_counts_converters_round_trip():
    rng = np.random.default_rng(1)
    arrays = (rng.integers(0, 99, (8, 2)).astype(np.int32),
              rng.integers(-3, 3, 8).astype(np.int32), rng.random(8) < 0.5)
    c = convert.counts_from_arrays(*arrays)
    assert c.codes.dtype == torch.int32 and c.unique_mask.dtype == torch.bool
    for a, b in zip(convert.counts_to_numpy(c), arrays):
        np.testing.assert_array_equal(a, b)
