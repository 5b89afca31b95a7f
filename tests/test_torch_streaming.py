"""Streaming discovery of the port against the JAX package.

The port's :class:`StreamingMiner` on ``backend="cuda"`` with
``device="cpu"`` (so the flat kernel's plain version on the fused path,
and the dense kernel's on ``fused="off"``) gives the same non-final and
final snapshots — counts, ``n_zones`` and ``e_cap`` — as the JAX
package's miner on ``backend="ref"``, and every snapshot equals JAX batch
``discover`` on the closed prefix.  Every case of the JAX package's
``tests/test_streaming.py`` is mirrored, with the JAX package's batch
``discover`` (or its oracle) as the expected value.  ``state_dict`` equals
the JAX one key for key, and a state moves between the packages.

Tolerance: none.  Every count table, zone count and capacity is compared
exactly.  The cross-package state tests run ``backend="ref"``, a backend
both packages have (a state restores only into its own config and
tail-layout signature), without a memory budget (with one, the ``cuda``
memory model derives other zone chunks than the JAX package by
design).
"""

import functools

import numpy as np
import pytest
import torch

from repro.core import MiningConfig as JaxConfig
from repro.core import PTMTEngine as JaxEngine
from repro.core import StreamingMiner as JaxMiner
from repro.core import oracle
from repro.core.temporal_graph import TemporalGraph
from repro_torch.core import MiningConfig, PTMTEngine, StreamingMiner
from repro_torch.core import streaming
from conftest import random_graph
from torch_corpus import CASE_IDS, CASES


def _prefix(g: TemporalGraph, cut_time: int) -> TemporalGraph:
    cut = int(np.searchsorted(g.t, cut_time, side="left"))
    return TemporalGraph(u=g.u[:cut], v=g.v[:cut], t=g.t[:cut],
                         n_nodes=g.n_nodes)


def _chunks(g: TemporalGraph, chunk: int):
    for i in range(0, g.n_edges, chunk):
        yield g.u[i:i + chunk], g.v[i:i + chunk], g.t[i:i + chunk]


def _feed(miner, g: TemporalGraph, chunk: int) -> None:
    for u, v, t in _chunks(g, chunk):
        miner.ingest(u, v, t)


def _jax_batch(g: TemporalGraph, **cfg):
    return JaxEngine(JaxConfig(**cfg)).discover(g)


@functools.lru_cache(maxsize=None)
def _jax_prefix_counts(spec: tuple, cut_time, delta, l_max, omega) -> dict:
    """JAX batch counts of ``random_graph(*spec)`` cut at ``cut_time``
    (None: the whole graph), shared by the cases that ask for them."""
    g = random_graph(*spec)
    if cut_time is not None:
        g = _prefix(g, cut_time)
    return _jax_batch(g, delta=delta, l_max=l_max, omega=omega).counts


def _miner(**kw) -> StreamingMiner:
    return StreamingMiner(device="cpu", **kw)


def _view(res) -> tuple:
    return res.counts, res.n_zones, res.e_cap


# ---------------------------------------------------------------------------
# The port's miner against the JAX miner, snapshot for snapshot.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_replay(case: str, chunk: int):
    """The JAX miner's snapshot after every chunk, then its final one:
    ``([(closed_time, counts, n_zones, e_cap)], final)``."""
    _, make, (delta, l_max, omega) = CASES[CASE_IDS.index(case)]
    g = make()
    miner = JaxMiner(config=JaxConfig(delta=delta, l_max=l_max,
                                      omega=omega, backend="ref"))
    snaps = []
    for u, v, t in _chunks(g, chunk):
        miner.ingest(u, v, t)
        snaps.append((miner.closed_time, *_view(miner.snapshot())))
    return snaps, _view(miner.snapshot(final=True))


@pytest.mark.parametrize("fused", ["auto", "off"])
@pytest.mark.parametrize("chunk", [37, 97, 1000])
@pytest.mark.parametrize("case", CASE_IDS)
def test_snapshots_match_jax_miner(case, chunk, fused):
    _, make, (delta, l_max, omega) = CASES[CASE_IDS.index(case)]
    g = make()
    miner = _miner(config=MiningConfig(delta=delta, l_max=l_max,
                                       omega=omega, backend="cuda",
                                       fused=fused))
    want, want_final = _jax_replay(case, chunk)
    for (u, v, t), (closed, *snap) in zip(_chunks(g, chunk), want):
        miner.ingest(u, v, t)
        assert miner.closed_time == closed
        assert _view(miner.snapshot()) == tuple(snap), f"at t={closed}"
    assert _view(miner.snapshot(final=True)) == want_final
    # the last non-final snapshot is batch discover on the closed prefix
    expect = _jax_batch(_prefix(g, miner.closed_time), delta=delta,
                        l_max=l_max, omega=omega)
    assert miner.snapshot().counts == expect.counts


def test_fused_and_per_bucket_paths_of_the_miner():
    """``fused="auto"`` takes the fused path (the flat kernel's plain
    version on a CPU device), ``fused="off"`` one scan per bucket."""
    _, make, (delta, l_max, omega) = CASES[0]
    paths = {}
    for fused in ("auto", "off"):
        miner = _miner(config=MiningConfig(delta=delta, l_max=l_max,
                                           omega=omega, backend="cuda",
                                           fused=fused))
        ran, run = [], miner.executor.run_layout

        def tap(layout, **kw):
            out = run(layout, **kw)
            ran.append(out.stats["path"])
            return out

        miner.executor.run_layout = tap
        _feed(miner, make(), 50)
        miner.snapshot()
        paths[fused] = set(ran)
    assert paths == {"auto": {"fused_torch"}, "off": {"per-bucket"}}


# ---------------------------------------------------------------------------
# Checkpoint state: the JAX dict, key for key, and across packages.
# ---------------------------------------------------------------------------

_STATE_CFG = dict(delta=20, l_max=4, omega=3, backend="ref")


def _state_graph():
    return random_graph(6, 800, 10, 2_600)


def _assert_states_equal(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for key, w in want.items():
        g = got[key]
        if isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray) and g.dtype == w.dtype, key
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            assert type(g) is type(w) and g == w, key


@pytest.mark.parametrize("cut", [0, 300, 800])
def test_state_dict_equals_jax(cut):
    g = _state_graph()
    port = _miner(config=MiningConfig(**_STATE_CFG))
    jax = JaxMiner(config=JaxConfig(**_STATE_CFG))
    head = TemporalGraph(u=g.u[:cut], v=g.v[:cut], t=g.t[:cut],
                         n_nodes=g.n_nodes)
    for m in (port, jax):
        _feed(m, head, 100)
    _assert_states_equal(port.state_dict(), jax.state_dict())


@pytest.mark.parametrize("direction", ["jax->port", "port->jax"])
def test_state_restores_across_packages(direction):
    """A state captured mid-stream in one package, restored in the other
    and fed the rest, ends at the uninterrupted final counts."""
    g = _state_graph()
    half, rest = g.n_edges // 2, g.n_edges - g.n_edges // 2
    first = (JaxMiner(config=JaxConfig(**_STATE_CFG))
             if direction == "jax->port"
             else _miner(config=MiningConfig(**_STATE_CFG)))
    for i in range(0, half, 100):
        j = min(i + 100, half)
        first.ingest(g.u[i:j], g.v[i:j], g.t[i:j])
    state = first.state_dict()
    second = (_miner(config=MiningConfig(**_STATE_CFG))
              if direction == "jax->port"
              else JaxMiner(config=JaxConfig(**_STATE_CFG)))
    second.restore_state(state)
    _assert_states_equal(second.state_dict(), state)
    for i in range(half, half + rest, 100):
        j = min(i + 100, g.n_edges)
        second.ingest(g.u[i:j], g.v[i:j], g.t[i:j])
        first.ingest(g.u[i:j], g.v[i:j], g.t[i:j])
    assert second.snapshot().counts == first.snapshot().counts
    assert second.snapshot(final=True).counts == \
        first.snapshot(final=True).counts
    assert first.snapshot(final=True).counts == _jax_batch(
        g, **{k: v for k, v in _STATE_CFG.items() if k != "backend"}).counts


def test_restore_rejects_another_config_or_tail_signature():
    port = _miner(config=MiningConfig(**_STATE_CFG))
    _feed(port, _state_graph(), 200)
    state = port.state_dict()
    with pytest.raises(ValueError, match="does not match"):
        _miner(config=MiningConfig(**{**_STATE_CFG, "delta": 25})) \
            .restore_state(state)
    with pytest.raises(ValueError, match="tail-layout signature"):
        _miner(config=MiningConfig(**_STATE_CFG)).restore_state(
            dict(state, tail_sig=["auto", None, 8]))


# ---------------------------------------------------------------------------
# The JAX package's tests/test_streaming.py, case for case.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["ref", "numpy", "cuda"])
@pytest.mark.parametrize("chunk", [64, 97, 10_000])   # 97 is a non-divisor
def test_snapshot_matches_batch_on_closed_prefix(backend, chunk):
    spec = (5, 700, 11, 2_500)
    g = random_graph(*spec)
    cfg = (20, 4, 3)
    miner = _miner(delta=cfg[0], l_max=cfg[1], omega=cfg[2],
                   backend=backend)
    _feed(miner, g, chunk)

    snap = miner.snapshot()
    expect = _jax_prefix_counts(spec, miner.closed_time, *cfg)
    assert snap.counts == expect, f"chunk={chunk}"

    final = miner.snapshot(final=True)
    assert final.counts == _jax_prefix_counts(spec, None, *cfg), \
        f"chunk={chunk} (final)"


def test_intermediate_snapshots_are_exact():
    g = random_graph(8, 600, 9, 2_000)
    delta, l_max, omega = 25, 3, 2
    miner = _miner(delta=delta, l_max=l_max, omega=omega, backend="cuda")
    chunk = 150
    for i in range(0, g.n_edges, chunk):
        miner.ingest(g.u[i:i + chunk], g.v[i:i + chunk], g.t[i:i + chunk])
        snap = miner.snapshot()
        prefix = _prefix(g, miner.closed_time)
        expect = _jax_batch(prefix, delta=delta, l_max=l_max, omega=omega)
        assert snap.counts == expect.counts, f"at edge {i}"
        assert snap.total_processes() == prefix.n_edges


def test_streaming_with_adaptive_e_cap():
    from repro_torch.data import synthetic_graphs as sg

    g = sg.bursty_stream(500, 12, seed=3)
    delta, l_max = 60, 4
    miner = _miner(delta=delta, l_max=l_max, omega=4, e_cap=64,
                   backend="cuda")
    _feed(miner, g, 120)
    final = miner.snapshot(final=True)
    expect = dict(oracle.count_codes(g.u, g.v, g.t, delta, l_max))
    assert final.counts == expect


def test_frontier_retires_edges():
    g = random_graph(2, 900, 10, 9_000)
    miner = _miner(delta=10, l_max=3, omega=2, backend="cuda")
    _feed(miner, g, 100)
    assert miner.n_edges_retired > 0
    assert miner.buffered_edges < g.n_edges
    assert miner.buffered_edges + miner.n_edges_retired == g.n_edges
    assert miner.n_zones_finalized > 0


def test_quiet_gap_is_skipped_not_walked():
    miner = _miner(delta=1, l_max=3, omega=2, backend="cuda")
    miner.ingest([0], [1], [0])
    miner.ingest([1], [2], [100_000_000])       # would be ~33M empty pairs
    assert miner.n_zones_finalized <= 4
    miner.ingest([2], [3], [100_000_050])
    final = miner.snapshot(final=True)
    assert final.counts == {"01": 3}


def test_invalid_parameters_rejected():
    with pytest.raises(ValueError, match="delta and l_max"):
        _miner(delta=0, l_max=3)
    with pytest.raises(ValueError, match="delta and l_max"):
        _miner(delta=10, l_max=0)
    with pytest.raises(ValueError, match="omega"):
        _miner(delta=10, l_max=3, omega=1)
    with pytest.raises(ValueError, match="not both"):
        _miner(config=MiningConfig(delta=10, l_max=3), delta=10)


def test_out_of_order_chunk_rejected():
    miner = _miner(delta=10, l_max=3)
    miner.ingest([0], [1], [100])
    with pytest.raises(ValueError, match="time-ordered"):
        miner.ingest([1], [2], [50])
    with pytest.raises(ValueError, match="non-decreasing"):
        miner.ingest([0, 1], [1, 2], [200, 150])


@pytest.mark.parametrize("bad,match", [
    (dict(u=[0.5]), "integer-typed"),
    (dict(v=[2**31]), "outside int32"),
    (dict(t=np.asarray([2**63], np.uint64)), "outside int64"),
    (dict(u=[0, 1]), "identical shapes"),
])
def test_validate_edge_chunk_rejects_what_would_wrap(bad, match):
    chunk = {"u": [0], "v": [1], "t": [5], **bad}
    with pytest.raises(ValueError, match=match):
        streaming.validate_edge_chunk(chunk["u"], chunk["v"], chunk["t"])
    miner = _miner(delta=10, l_max=3)
    with pytest.raises(ValueError, match=match):
        miner.ingest(chunk["u"], chunk["v"], chunk["t"])
    assert miner.n_edges_ingested == 0


def test_large_epoch_timestamps():
    g = random_graph(4, 400, 8, 1_500)
    delta, l_max, omega = 20, 3, 2
    offset = np.int64(3_000_000_000)          # > 2**31
    miner = _miner(delta=delta, l_max=l_max, omega=omega, backend="cuda")
    for i in range(0, g.n_edges, 90):
        miner.ingest(g.u[i:i + 90], g.v[i:i + 90],
                     g.t[i:i + 90].astype(np.int64) + offset)
    final = miner.snapshot(final=True)
    expect = _jax_batch(g, delta=delta, l_max=l_max, omega=omega)
    assert final.counts == expect.counts


def test_snapshot_reuses_tail_within_epoch():
    g = random_graph(6, 800, 10, 2_600)
    delta, l_max, omega = 20, 4, 3
    miner = _miner(delta=delta, l_max=l_max, omega=omega, backend="cuda")
    _feed(miner, g, 200)

    first = miner.snapshot()
    assert miner.tail_cache_misses == 1
    again = miner.snapshot()
    assert miner.tail_cache_hits == 1 and miner.tail_cache_misses == 1
    assert again.counts == first.counts
    assert again.n_zones == first.n_zones

    fin = miner.snapshot(final=True)
    assert miner.tail_cache_misses == 1
    assert fin.counts == _jax_batch(g, delta=delta, l_max=l_max,
                                    omega=omega).counts

    epoch = miner.epoch
    t0 = int(miner.t_head)
    i = 0
    while miner.epoch == epoch:
        i += 1
        miner.ingest([0], [1], [t0 + 50 * i])
    snap = miner.snapshot()
    assert miner.tail_cache_misses == 2
    u = np.concatenate([g.u, np.zeros(i, g.u.dtype)])
    v = np.concatenate([g.v, np.ones(i, g.v.dtype)])
    t = np.concatenate([g.t, t0 + 50 * np.arange(1, i + 1, dtype=g.t.dtype)])
    full = TemporalGraph(u=u, v=v, t=t, n_nodes=g.n_nodes)
    expect = _jax_batch(_prefix(full, miner.closed_time), delta=delta,
                        l_max=l_max, omega=omega)
    assert snap.counts == expect.counts


def test_empty_and_tiny_streams():
    miner = _miner(delta=10, l_max=3, backend="cuda")
    assert miner.snapshot().counts == {}
    miner.ingest(np.array([], int), np.array([], int), np.array([], int))
    assert miner.snapshot().counts == {}
    miner.ingest([3], [8], [100])
    assert miner.snapshot().counts == {}          # head not yet closed
    assert miner.snapshot(final=True).counts == {"01": 1}


def test_replay_stream_times_every_chunk():
    g = random_graph(3, 250, 8, 1_000)
    miner = _miner(delta=20, l_max=3, omega=2, backend="cuda")
    latencies, total = streaming.replay_stream(miner, g, 64)
    assert len(latencies) == 4 and total >= sum(latencies) > 0
    assert miner.n_edges_ingested == g.n_edges
    with pytest.raises(ValueError, match="chunk_edges"):
        streaming.replay_stream(miner, g, 0)


# ---------------------------------------------------------------------------
# Devices: CUDA unless asked, never the CPU quietly.
# ---------------------------------------------------------------------------


def test_miner_and_engine_stream_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamingMiner(delta=10, l_max=3, backend="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamingMiner(delta=10, l_max=3, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PTMTEngine(MiningConfig(backend="cuda")).stream()


def test_engine_stream_shares_the_executor_and_device():
    engine = PTMTEngine(MiningConfig(delta=20, l_max=3, omega=2,
                                     backend="cuda"), device="cpu")
    shared = engine.stream()
    assert shared.executor is engine.executor
    # overrides build the miner's own executor, on the engine's device
    derived = engine.stream(delta=30)
    assert derived.executor is not engine.executor
    assert derived.executor.device == torch.device("cpu")
    assert derived.config.delta == 30
    assert engine.stats.stream_sessions == 2
    with pytest.raises(ValueError, match="not both"):
        StreamingMiner(config=engine.config, executor=engine.executor,
                       device="cpu")
    g = random_graph(9, 300, 8, 1_200)
    _feed(derived, g, 80)
    assert derived.snapshot(final=True).counts == _jax_batch(
        g, delta=30, l_max=3, omega=2).counts
