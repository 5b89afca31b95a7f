"""The port's public names against the JAX package's: the removed-name
shims, every ``__all__``, the zone-scan oracles and the fused launch's
traffic model (tolerance 0: every scan output is int32)."""

import ast
import importlib
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tzp as j_tzp
from repro.kernels.zone_scan import ref as jax_ref
from repro_torch.core import (
    discover,
    discover_sequential,
    encoding,
    from_edges,
    planner,
    tzp,
)
from repro_torch.kernels.zone_scan import ops, ref
from torch_corpus import CASE_IDS, CASES, to_torch

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"

#: JAX modules with an ``__all__`` that have no port, and why
JAX_ONLY_MODULES = {
    # the Pallas interpret switch and trace counter: the port's kernels
    # are built by nvcc (kernels/_build.py) and have no interpret mode
    "kernels.common": "Pallas-only",
}
#: names of a JAX ``__all__`` the port's counterpart leaves out, and why
#: (none today: every exported name is ported)
JAX_ONLY_NAMES: dict[str, set] = {}


def _all_of(path: pathlib.Path):
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return set(ast.literal_eval(node.value))
    return None


def _jax_modules_with_all():
    root = SRC / "repro"
    for path in sorted(root.rglob("*.py")):
        names = _all_of(path)
        if names is None:
            continue
        rel = path.relative_to(root).with_suffix("").parts
        if rel[-1] == "__init__":
            rel = rel[:-1]
        yield ".".join(rel), names


JAX_EXPORTS = list(_jax_modules_with_all())


# -- removed shims -----------------------------------------------------------

def test_discover_shims_removed_with_engine_pointer():
    """``repro_torch.core`` keeps the JAX package's removed one-shot
    functions importable; calling raises with migration instructions
    (the JAX package's ``test_discover_shims_removed_with_engine_pointer``)."""
    rng = np.random.default_rng(3)
    g = from_edges(rng.integers(0, 20, 200), rng.integers(0, 20, 200),
                   np.sort(rng.integers(0, 2_000, 200)))
    with pytest.raises(RuntimeError, match="PTMTEngine"):
        discover(g, delta=60, l_max=3, omega=4)
    with pytest.raises(RuntimeError, match="PTMTEngine"):
        discover_sequential(g, delta=60, l_max=3)


@pytest.mark.parametrize("name,method", [("discover", "discover"),
                                         ("discover_sequential",
                                          "sequential")])
def test_shim_message_names_the_port(name, method):
    fn = getattr(importlib.import_module("repro_torch.core"), name)
    with pytest.raises(RuntimeError) as err:
        fn()
    msg = str(err.value)
    assert f"repro_torch.core.{name}(...)" in msg
    assert f".{method}(graph)" in msg
    assert "engine.sharded(graph, mesh, axes)" in msg
    assert "compiled" not in msg


# -- exports -----------------------------------------------------------------

def test_every_jax_export_list_is_seen():
    names = {m for m, _ in JAX_EXPORTS}
    assert {"core", "data", "models", "serving",
            "kernels.zone_scan.ref"} <= names
    assert set(JAX_ONLY_MODULES) <= names


@pytest.mark.parametrize("module,names", JAX_EXPORTS,
                         ids=[m for m, _ in JAX_EXPORTS])
def test_port_all_holds_the_jax_all(module, names):
    if module in JAX_ONLY_MODULES:
        rel = module.replace(".", "/")
        assert not (SRC / "repro_torch" / f"{rel}.py").exists()
        assert not (SRC / "repro_torch" / rel / "__init__.py").exists()
        return
    port = importlib.import_module(f"repro_torch.{module}")
    want = names - JAX_ONLY_NAMES.get(module, set())
    assert want <= set(port.__all__), sorted(want - set(port.__all__))
    for name in port.__all__:
        assert hasattr(port, name), name


# -- the zone-scan oracles ---------------------------------------------------

def _flat(case, bounds):
    _, make, (delta, l_max, omega) = case
    g = make()
    plan = j_tzp.plan_zones(g, delta=delta, l_max=l_max, omega=omega)
    lay = j_tzp.build_zone_layout(g, plan, layout="bucketed")
    fl = j_tzp.concat_layout(lay, blk=512, delta=delta, l_max=l_max,
                             bounds=bounds)
    return lay, fl, delta, l_max


def _np(xs):
    return [None if x is None else np.asarray(x) for x in xs]


@pytest.mark.parametrize("with_ts", [False, True])
@pytest.mark.parametrize("bounds", ["full", "live"])
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_scan_flat_ref_matches_jax_and_plain(case, bounds, with_ts):
    _, fl, delta, l_max = _flat(case, bounds)
    stream = (fl.u, fl.v, fl.t, fl.valid, fl.zone_id)
    got = ref.scan_flat_ref(*to_torch(*stream), delta=delta, l_max=l_max,
                            with_ts=with_ts)
    assert isinstance(got, ref.ZoneResult)
    want = jax_ref.scan_flat_ref(*stream, delta=delta, l_max=l_max,
                                 with_ts=with_ts)
    plain = ref.fused_zone_scan_torch(
        *to_torch(*stream, fl.lo, fl.hi), delta=delta, l_max=l_max,
        blk=fl.blk, with_ts=with_ts)
    assert (got.ts is None) == (not with_ts)
    assert got.code.dtype == torch.int32
    assert got.code.shape == (fl.n_slots, encoding.n_limbs(l_max))
    for a, b, c in zip(_np(got), _np(want), _np(plain)):
        if a is None:
            continue
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert int((got.length > 0).sum()) == fl.valid_edges


def test_scan_flat_ref_empty_stream():
    z = torch.zeros(512, dtype=torch.int32)
    res = ref.scan_flat_ref(z, z, z, z, z - 1, delta=5, l_max=3,
                            with_ts=True)
    assert res.code.shape == (512, encoding.n_limbs(3))
    assert not res.code.any() and not res.length.any() and not res.ts.any()


@pytest.mark.parametrize("with_ts", [False, True])
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_scan_zone_matches_jax(case, with_ts):
    """``ops.scan_zone`` on CPU tensors (the plain version) and
    ``ref.scan_zone`` on every bucket's fullest row against the JAX
    reference's one-zone scan."""
    lay, _, delta, l_max = _flat(case, "full")
    for b in lay.buckets:
        row = int(np.argmax(b.valid.sum(axis=1)))
        arrays = (b.u[row], b.v[row], b.t[row], b.valid[row])
        want = _np(jax_ref.scan_zone(*(jnp.asarray(x) for x in arrays),
                                     delta=delta, l_max=l_max,
                                     with_ts=with_ts))
        for fn in (ops.scan_zone, ref.scan_zone):
            got = fn(*to_torch(*arrays), delta=delta, l_max=l_max,
                     with_ts=with_ts)
            assert isinstance(got, ref.ZoneResult)
            assert got.length.shape == (b.e_cap,)
            assert (got.ts is None) == (not with_ts)
            for a, w in zip(_np(got), want):
                if a is not None:
                    np.testing.assert_array_equal(a, w)


def test_scan_zone_counts_no_launch_on_the_cpu():
    ops.reset_launches()
    g = torch.tensor([0, 1, 1], dtype=torch.int32)
    ops.scan_zone(g, g + 1, torch.arange(3, dtype=torch.int32),
                  torch.ones(3, dtype=torch.bool), delta=5, l_max=2)
    assert not any(ops.launches.values())


# -- traffic model -----------------------------------------------------------

@pytest.mark.parametrize("bounds", ["full", "live"])
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_fused_traffic_bytes_counts_the_launch_tensors(case, bounds):
    """One read of each slot input and each block's ``hi`` (the launch's
    reads, ``fused_input_bytes``), one write and one read back of each
    output, worked out from a real fused layout's arrays and the launch's
    outputs."""
    _, make, (delta, l_max, omega) = case
    g = make()
    plan = tzp.plan_zones(g, delta=delta, l_max=l_max, omega=omega)
    lay = tzp.build_zone_layout(g, plan, layout="bucketed")
    fl = tzp.concat_layout(lay, blk=512, delta=delta, l_max=l_max,
                           bounds=bounds)
    inputs = (fl.u, fl.v, fl.t, fl.valid, fl.zone_id)
    assert all(x.dtype == np.int32 for x in (*inputs, fl.hi))
    code, length = ops.scan_flat(
        *to_torch(*inputs, fl.lo, fl.hi), delta=delta, l_max=l_max,
        blk=fl.blk)
    out_bytes = (code.numel() * code.element_size()
                 + length.numel() * length.element_size())
    reads = sum(x.nbytes for x in inputs) + fl.hi.nbytes
    assert planner.fused_input_bytes(fl) == reads
    assert planner.fused_traffic_bytes(fl, l_max) == reads + 2 * out_bytes
