"""The plain reference against the program on the CPU, and the
comparison that decides ``correct``."""

from __future__ import annotations

import os
import tempfile

import numpy as np
import pytest
import torch

from ptmt_bench.data import powerlaw_stream, tzp_block
from ptmt_bench.reference import compare, ptmt_ref

GEN = {"n_nodes": 80, "alpha": 1.5}


@pytest.mark.parametrize("seed,n_edges,rate,delta,l_max", [
    (1, 1500, 0.2, 60, 4),
    (2, 1500, 0.2, 30, 6),
    (3, 2000, 1.0, 600, 6),
    (2**31 + 11, 800, 0.05, 10, 1),
    (5, 1200, 0.5, 120, 7),
])
def test_discover_equals_program(seed, n_edges, rate, delta, l_max):
    from repro_torch.core import MiningConfig, PTMTEngine
    from repro_torch.core.temporal_graph import TemporalGraph

    u, v, t, n = powerlaw_stream.generate(seed=seed, n_edges=n_edges,
                                          rate=rate, **GEN)
    keys, counts, steps, node_steps = ptmt_ref.graph_counts(
        u, v, t, delta=delta, l_max=l_max)
    engine = PTMTEngine(MiningConfig(backend="cuda", delta=delta,
                                     l_max=l_max, omega=5), device="cpu")
    got = engine.discover(TemporalGraph(u=u, v=v, t=t, n_nodes=n)).counts
    want = ptmt_ref.table_dict(keys, counts, l_max)
    assert got == want
    assert compare.dict_mismatch(got, want) == 0
    assert counts.sum() == n_edges and len(steps) == n_edges
    assert (node_steps >= 0).all() and (node_steps <= (steps - 1) * (
        l_max + 1)).all()


def test_graph_matches_program_generator():
    from repro_torch.data import synthetic_graphs

    u, v, t, n = powerlaw_stream.generate(seed=2**31 + 3, n_edges=5000,
                                          n_nodes=986, alpha=1.5, rate=1.0)
    g = synthetic_graphs.powerlaw_stream(5000, 986, seed=2**31 + 3)
    for a, b in ((u, g.u), (v, g.v), (t, g.t)):
        assert a.dtype == b.dtype and (a == b).all()
    assert n == g.n_nodes


@pytest.mark.parametrize("seed,rate,e_cap", [(4, 0.01, 128),
                                             (2**31 + 9, 0.004, 96)])
def test_block_is_the_program_plan(seed, rate, e_cap):
    """The frozen planner cuts the zones, signs and rows the program's
    TZP plans for ``zone_layout="dense"``."""
    from repro_torch.core import tzp
    from repro_torch.core.temporal_graph import TemporalGraph

    g = powerlaw_stream.generate(seed=seed, n_edges=4000, rate=rate, **GEN)
    z = 10
    batch = tzp_block.build(g, delta=600, l_max=6, omega=20, n_zones=z,
                            e_cap=e_cap)
    graph = TemporalGraph(u=g[0], v=g[1], t=g[2], n_nodes=g[3])
    plan = tzp.plan_zones(graph, delta=600, l_max=6, omega=20, e_cap=e_cap)
    first = tzp.ZonePlan(lo=plan.lo[:z], count=plan.count[:z],
                         sign=plan.sign[:z], t_start=plan.t_start[:z],
                         t_end=plan.t_end[:z], l_b=plan.l_b)
    want = tzp.build_zone_batch(graph, first, e_cap=e_cap)
    assert want.overflow == 0
    for got, ref in zip(batch, (want.u, want.v, want.t, want.valid,
                                want.sign)):
        assert got.dtype == ref.dtype and (got == ref).all()
    assert sorted(batch[4].tolist()) == [-1] * (z // 2) + [1] * (z // 2)
    with pytest.raises(ValueError, match="more edges"):
        tzp_block.build(g, delta=600, l_max=6, omega=20, n_zones=10**4,
                        e_cap=e_cap)
    with pytest.raises(ValueError, match="more than its row"):
        tzp_block.build(g, delta=600, l_max=6, omega=20, n_zones=z,
                        e_cap=16)


@pytest.mark.parametrize("seed", [4, 2**31 + 9])
def test_mining_step_equals_program(seed):
    import dataclasses

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import ptmt

    g = powerlaw_stream.generate(seed=seed, n_edges=4000, rate=0.01, **GEN)
    batch = tzp_block.build(g, delta=600, l_max=6, omega=20, n_zones=8,
                            e_cap=128)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1)
        try:
            mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("z",))
            cfg = dataclasses.replace(ptmt.CONFIG, backend="cuda",
                                      out_cap=8 * 128)
            step = ptmt.mining_workload(
                cfg, ptmt.MiningShape("tiny", 8, 128), mesh).fn
            out, overflow = step(*(torch.as_tensor(x) for x in batch))
        finally:
            dist.destroy_process_group()
    keys, counts, _, _ = ptmt_ref.zone_counts(*batch, delta=600, l_max=6)
    mask = out.unique_mask.numpy()
    got = compare.limb_keys(out.codes.numpy()[mask], 6)
    assert int(overflow) == 0
    assert compare.table_mismatch(got, out.counts.numpy()[mask], keys,
                                  counts) == 0
    # the program keeps cancelled codes as rows of count 0: same order
    assert (got == keys).all() and (out.counts.numpy()[mask] == counts).all()


def test_walk_by_hand():
    """A stream counted by hand (delta 10, l_max 3)."""
    #        0       1       2       3       4       5
    u = [1, 2, 5, 2, 9, 3]
    v = [2, 3, 6, 1, 9, 4]
    t = [0, 0, 5, 8, 30, 31]
    key, steps, nodes = ptmt_ref.walk(
        *(torch.tensor(x) for x in (u, v, t)), torch.arange(6),
        torch.full((6,), 6), delta=10, l_max=3)
    codes = [ptmt_ref.key_to_string(k, 3) for k in key.tolist()]
    # seed 0 (1,2): slot 1 has t == 0, not later: skipped; slot 2 shares
    # no node; slot 3 (2,1) absorbed at 8; slot 4 at 30 > 18: stop
    # seed 1 (2,3): slot 3 (2,1) at 8, node 1 new; slot 4 past 18: stop
    # seed 2 (5,6): nothing shares a node; slot 4 at 30 > 15: stop
    # seed 3 (2,1): slot 4 at 30 > 18: stop
    # seed 4 (9,9): slot 5 (3,4) shares nothing; stream ends
    # seed 5: stream ends at once
    assert codes == ["0110", "0102", "01", "01", "00", "01"]
    assert steps.tolist() == [1 + 4, 1 + 3, 1 + 2, 1 + 1, 1 + 1, 1]
    # node tests: a slot later than the newest edge and inside its window
    # against the nodes held then; seed 0: slots 2 and 3 against 2 nodes
    # (slot 1 is at the seed's own time, slot 4 past the window); seed 1:
    # slot 2 and 3 against 2; seed 2: slot 3 against 2 (slot 4 past);
    # seed 3: none (slot 4 past); seed 4: slot 5 against its 1 node
    assert nodes.tolist() == [4, 4, 2, 0, 1, 0]


def test_walk_stops_at_l_max():
    u = torch.tensor([1, 1, 2, 2, 1])
    v = torch.tensor([2, 3, 3, 4, 4])
    t = torch.tensor([0, 1, 2, 3, 4])
    key, steps, nodes = ptmt_ref.walk(u, v, t, torch.tensor([0]),
                                      torch.tensor([5]), delta=5, l_max=3)
    assert ptmt_ref.key_to_string(int(key[0]), 3) == "010212"
    assert steps.tolist() == [3]
    # slot 1 against {1, 2}, slot 2 against {1, 2, 3}
    assert nodes.tolist() == [2 + 3]


def test_limb_keys_read_the_program_format():
    from repro_torch.core import encoding

    rng = np.random.default_rng(0)
    strings = ["01", "0112", "010212", "0102030405060708"[:12], "001021"]
    for _ in range(20):
        n = int(rng.integers(1, 7))
        strings.append("".join(format(int(d), "x")
                               for d in rng.integers(0, 7, 2 * n)))
    codes = np.stack([encoding.encode_label_string_np(s, 6)
                      for s in strings])
    keys = compare.limb_keys(codes, 6)
    assert [ptmt_ref.key_to_string(k, 6) for k in keys] == strings
    longer = encoding.encode_label_string_np("01" * 7, 7)[None]
    assert compare.limb_keys(longer, 6)[0] == -1


def test_table_mismatch_counts_each_code():
    rk, rc = np.array([3, 5, 9, 12]), np.array([1, 0, 2, -1])
    assert compare.table_mismatch(rk, rc, rk, rc) == 0
    # a cancelled code may be kept as a row of 0 or left out
    assert compare.table_mismatch([3, 9, 12], [1, 2, -1], rk, rc) == 0
    assert compare.table_mismatch([3, 9, 12], [1, 3, -1], rk, rc) == 1
    assert compare.table_mismatch([3, 9], [1, 2], rk, rc) == 1
    assert compare.table_mismatch([3, 9, 12, 14], [1, 2, -1, 1], rk, rc) == 1
    assert compare.table_mismatch([3, 3, 9, 12], [1, 1, 2, -1], rk, rc) == 1
    assert compare.dict_mismatch({"01": 2, "0110": 1}, {"01": 2}) == 1
    assert compare.dict_mismatch({"01": 2}, {"01": 2, "00": 0}) == 0
