"""The sharded mining step's spans on the card (skipped without one).

On CUDA every span of a traced step carries a device interval made of two
timing events.  This checks, on a one-rank NCCL mesh, that each interval
lies where the host's span put its work (no earlier than the span opened,
inside its parent's interval, on the host's clock) and that tracing adds
no wait to the step: no ``torch.cuda.synchronize`` and no implicit
synchronization beyond what the untraced step does.  The CPU cases of the
same step are in ``test_torch_distributed.py``; this file imports no JAX,
so it runs on the card's machine as it is:
``PYTHONPATH=src python -m pytest -q tests/test_torch_mining_trace.py``.
"""

import warnings

import pytest
import torch

from repro_torch import obs
from repro_torch.core import tzp
from repro_torch.data import synthetic_graphs
from repro_torch.distributed import mining

#: how far (seconds) an event may seem to precede the host's timestamp
#: before it: the anchor's host time is the midpoint of its record call
SLACK_S = 50e-6


@pytest.fixture
def nccl_mesh(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("device intervals are CUDA events: it needs the card")
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1)
    try:
        yield init_device_mesh("cuda", (1,), mesh_dim_names=("z",))
    finally:
        dist.destroy_process_group()


def _batch():
    g = synthetic_graphs.bursty_stream(6_000, 40, seed=3)
    plan = tzp.plan_zones(g, delta=600, l_max=4, omega=6)
    b = tzp.build_zone_batch(g, plan)
    return [torch.as_tensor(x, device="cuda")
            for x in (b.u, b.v, b.t, b.valid, b.sign)]


def _waits(fn, arrays, monkeypatch, steps=3):
    """``(explicit synchronizes, implicit-sync warnings)`` of ``steps``
    calls of a warm step, and its outputs."""
    calls = []
    real = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: (calls.append(a), real(*a, **k)))
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            outs = [fn(*arrays) for _ in range(steps)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
        monkeypatch.setattr(torch.cuda, "synchronize", real)
    return len(calls), len(caught), outs


@pytest.mark.parametrize("merge_mode", ["flat", "hierarchical"])
def test_step_device_intervals_follow_their_host_spans(nccl_mesh,
                                                       monkeypatch,
                                                       merge_mode):
    arrays = _batch()
    live = obs.enabled()
    kw = dict(delta=600, l_max=4, backend="cuda", out_cap=arrays[0].numel(),
              merge_mode=merge_mode)
    traced = mining.make_mine_step(nccl_mesh, ("z",), obs=live, **kw)
    plain = mining.make_mine_step(nccl_mesh, ("z",), **kw)
    for fn in (traced, plain):      # builds B3 and the tracer's clock
        fn(*arrays)
    torch.cuda.synchronize()

    n_sync, n_implicit, outs = _waits(traced, arrays, monkeypatch)
    _, n_implicit_plain, plain_outs = _waits(plain, arrays, monkeypatch)
    assert n_sync == 0
    assert n_implicit == n_implicit_plain
    for (a, fa), (b, fb) in zip(outs, plain_outs):
        assert int(fa) == int(fb) == 0
        assert all(torch.equal(x, y) for x, y in zip(a, b))

    host = {e["args"]["id"]: e for e in live.tracer.events()}
    origin = live.tracer._origin
    device = live.tracer.device_events()
    assert len(device) == len(host) == 4 * 6
    by_id = {d["id"]: d for d in device}
    for d in device:
        h = host[d["id"]]
        assert d["name"] == h["name"]
        assert d["start"] >= origin + h["ts"] / 1e6 - SLACK_S
        assert d["end"] >= d["start"]
        if d["parent"] is not None:    # one stream: inside its parent's
            p = by_id[d["parent"]]
            assert p["start"] - SLACK_S <= d["start"]
            assert d["end"] <= p["end"] + SLACK_S
    steps = sorted((d for d in device if d["name"] == "mine.step"),
                   key=lambda d: d["start"])
    assert all(a["end"] <= b["start"] + SLACK_S
               for a, b in zip(steps, steps[1:]))
