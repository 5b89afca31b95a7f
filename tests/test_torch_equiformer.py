"""The port's equiformer-v2 (``models/equiformer.py``) and the GNN
training workload against the JAX package: spherical harmonics, Wigner
blocks, the SO(2) convolution, the equivariant norm, the forward, loss and
gradients for node and graph readouts, rotation invariance and edge
chunking, configs and parameter trees, ``gnn_workload``'s step for
equiformer and gin-tu, and GNN layer checkpointing.

Parameters are made by the JAX package's ``tree_init`` and carried across
with ``convert.params_from_numpy``; graphs come from the same numpy seeds.
Tolerances:
- real spherical harmonics and the rotations: rtol 1e-5, atol 1e-5 x the
  largest magnitude (float32 recursions, the same operations);
- Wigner blocks: atol 1e-5.  Each package takes ``np.linalg.pinv`` of its
  own float32 SH values at the sample points (measured here: the same SH
  values and pinvs, bit for bit) and builds the blocks by its own
  einsums (measured: at most 4.7e-7 apart at l_max 6, entries up to 1);
  the pinvs are held at atol 1e-6, the rotated irreps at 2e-5;
- whole models (forward outputs, losses): rtol 1e-4, atol 1e-4 x the
  largest magnitude; gradients and AdamW moments: each leaf within rtol
  1e-4 and an atol of 1e-4 x the leaf's largest magnitude (measured on
  these graphs: at most 1e-6 relative);
- parameters after one AdamW step: rtol 1e-5, atol 1e-5 x the largest
  magnitude;
- the port's own rotation invariance and edge chunking: the JAX tests'
  tolerances (``tests/test_gnn_archs.py``); chunked or whole-layer
  checkpointed equiformer gradients against the plain run's: rtol 1e-5,
  atol 1e-6 x the leaf's largest magnitude (the backward graph differs,
  so a gradient's contributions are summed in another order; measured
  at most 5.2e-7 relative); checkpointed GNN layers: bitwise.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import gnn_common as jax_gnn_common
from repro.data import graph_data as jax_graph_data
from repro.models import equiformer as jax_eq
from repro.models import gnn as jax_gnn
from repro.models import params as jax_params
from repro.training import optimizer as jax_optimizer
from repro_torch.configs import get_arch, gnn_common
from repro_torch.core import convert
from repro_torch.data import graph_data
from repro_torch.models import equiformer, gnn, params
from repro_torch.training import optimizer
from repro_torch.training.tree import flatten_with_paths, leaves, \
    value_and_grad

TOL, STEP_TOL, SH_TOL, WIGNER_ATOL = 1e-4, 1e-5, 1e-5, 1e-5
N, E, F_IN = 48, 160, 12


def _np(x):
    if torch.is_tensor(x):
        return x.detach().numpy()
    return np.asarray(x)


def _close(got, want, tol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    atol = tol * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=tol, atol=atol)


def _hold_tree(got, want, tol=TOL):
    got = dict(flatten_with_paths(got))
    want = {"/".join(str(k) for k in p): v for p, v in
            jax.tree_util.tree_flatten_with_path(want)[0]}
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g, w = _np(got[path]), np.asarray(w)
        assert g.shape == w.shape, path
        atol = tol * max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, rtol=tol, atol=atol, err_msg=path)


def _one_device_mesh():
    return jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))


def _dirs(n, seed=0):
    v = np.random.default_rng(seed).standard_normal((n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


@functools.cache
def _case(readout="node", n_layers=None, seed=11):
    """``(jax cfg, cfg, jax graph, graph, jax params, params)`` of the smoke
    config specialised to a 48-node, 160-edge graph."""
    n_graphs, n_classes = (4, 1) if readout == "graph" else (0, 4)
    shape = jax_gnn_common.GNNShape("tiny", N, E, F_IN, n_classes,
                                    n_graphs=n_graphs)
    jcfg = jax_gnn_common._specialize(
        jax_get_arch("equiformer-v2").smoke_config, shape)
    if n_layers:
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
    kw = dict(n_nodes=N, n_edges=E, d_feat=F_IN, n_classes=n_classes,
              n_graphs=n_graphs, with_positions=True, seed=seed)
    jp = jax_params.tree_init(jax.random.PRNGKey(0),
                              jax_eq.equiformer_param_specs(jcfg))
    return (jcfg, convert.equiformer_config_from(jcfg),
            jax_graph_data.random_graph_batch(**kw),
            graph_data.random_graph_batch(**kw, device="cpu"),
            jp, convert.params_from_numpy(jp, "cpu"))


# -- building blocks ---------------------------------------------------------

@pytest.mark.parametrize("l_max", [3, 6])
def test_real_sph_harm_and_rotations_match_jax(l_max):
    d = _dirs(200)
    d[:2] = [[0, 0, 1], [0, 0, -1]]        # the poles: rxy clamps
    _close(equiformer.real_sph_harm(torch.as_tensor(d), l_max),
           jax_eq.real_sph_harm(jnp.asarray(d), l_max), SH_TOL)
    rot = equiformer.edge_alignment_rotation(torch.as_tensor(d))
    _close(rot, jax_eq.edge_alignment_rotation(jnp.asarray(d)), SH_TOL)
    # R @ rhat = +z away from the poles
    z = torch.einsum("eij,ej->ei", rot, torch.as_tensor(d))[2:]
    _close(z, np.tile([0, 0, 1], (198, 1)).astype(np.float32), 1e-5)


@pytest.mark.parametrize("l_max", [3, 6])
def test_wigner_blocks_and_rotate_irreps_match_jax(l_max):
    pts, pinvs = equiformer._sample_pinv(l_max)
    jpts, jpinvs = jax_eq._sample_pinv(l_max)
    np.testing.assert_array_equal(pts, jpts)
    for a, b in zip(pinvs, jpinvs, strict=True):
        np.testing.assert_allclose(a, b, atol=1e-6)
    d = _dirs(64, seed=1)
    rot = equiformer.edge_alignment_rotation(torch.as_tensor(d))
    jrot = jax_eq.edge_alignment_rotation(jnp.asarray(d))
    blocks = equiformer.wigner_blocks(rot, l_max)
    jblocks = jax_eq.wigner_blocks(jrot, l_max)
    for b, jb in zip(blocks, jblocks, strict=True):
        np.testing.assert_allclose(_np(b), np.asarray(jb), atol=WIGNER_ATOL)
    # D_l is orthogonal and maps Y_l(x) to Y_l(R x)
    for b in blocks:
        eye = torch.eye(b.shape[1]).expand_as(b)
        torch.testing.assert_close(b @ b.transpose(1, 2), eye, atol=1e-5,
                                   rtol=0)
    x = np.random.default_rng(2).standard_normal(
        (64, (l_max + 1) ** 2, 5)).astype(np.float32)
    for inverse in (False, True):
        # both packages' own blocks; the difference is the blocks'
        got = equiformer.rotate_irreps(torch.as_tensor(x), blocks,
                                       inverse=inverse)
        want = jax_eq.rotate_irreps(jnp.asarray(x), jblocks,
                                    inverse=inverse)
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-5)
        # on the JAX blocks the rotation itself agrees at float32
        got = equiformer.rotate_irreps(
            torch.as_tensor(x), [torch.as_tensor(np.array(b))
                                 for b in jblocks], inverse=inverse)
        _close(got, want, SH_TOL)
    back = equiformer.rotate_irreps(equiformer.rotate_irreps(
        torch.as_tensor(x), blocks), blocks, inverse=True)
    torch.testing.assert_close(back, torch.as_tensor(x), atol=2e-5, rtol=0)


def test_so2_conv_and_equivariant_ln_match_jax():
    jcfg, cfg, _, _, jp, p = _case()
    rng = np.random.default_rng(3)
    x = rng.standard_normal((40, cfg.n_irreps, cfg.d_hidden)) \
        .astype(np.float32)
    lp = {k: v[0] for k, v in p["layers"].items()}
    jlp = {k: v[0] for k, v in jp["layers"].items()}
    got = equiformer._so2_conv(torch.as_tensor(x), lp, cfg)
    _close(got, jax_eq._so2_conv(jnp.asarray(x), jlp, jcfg), 1e-5)
    # components with |m| > m_max stay zero
    kept = {i for s in equiformer._m_index_sets(cfg)[1:] for v in s.values()
            for i in v} | set(equiformer._m_index_sets(cfg)[0])
    dropped = sorted(set(range(cfg.n_irreps)) - kept)
    assert dropped and float(got[:, dropped].abs().max()) == 0
    scale = rng.standard_normal((cfg.l_max + 1, cfg.d_hidden)) \
        .astype(np.float32)
    _close(equiformer._equivariant_ln(torch.as_tensor(x),
                                      torch.as_tensor(scale), cfg),
           jax_eq._equivariant_ln(jnp.asarray(x), jnp.asarray(scale), jcfg),
           1e-5)
    _close(equiformer._radial_basis(torch.linspace(0, 7, 50), 32),
           jax_eq._radial_basis(jnp.linspace(0, 7, 50), 32), 1e-5)


# -- the model --------------------------------------------------------------

@pytest.mark.parametrize("readout", ["node", "graph"])
@pytest.mark.parametrize("n_layers", [2, 3])
def test_forward_loss_and_grads_match_jax(readout, n_layers):
    """The smoke widths at 2 layers and at 3: with 2, the |m| > 0 weights
    get no gradient in either package (only the scalars reach the
    readout, and the first layer's inputs are scalars); with 3 they do."""
    jcfg, cfg, jg, g, jp, p = _case(readout, n_layers)
    _close(equiformer.forward(p, g, cfg), jax_eq.forward(jp, jg, jcfg), TOL)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        functools.partial(jax_eq.loss_fn, cfg=jcfg)))(jp, jg)
    loss, grads = value_and_grad(equiformer.loss_fn)(p, g, cfg)
    _close(loss, jloss, TOL)
    _hold_tree(grads, jgrads)
    m_grads = float(grads["layers"]["w_m1_r"].abs().max())
    assert (m_grads > 0) == (n_layers > 2)


def test_zero_length_edges_are_masked():
    jcfg, cfg, jg, g, jp, p = _case()
    g = dict(g, edge_dst=g["edge_src"].clone())      # every edge a self-loop
    jg = dict(jg, edge_dst=jg["edge_src"])
    out = equiformer.forward(p, g, cfg)
    assert bool(torch.isfinite(out).all())
    _close(out, jax_eq.forward(jp, jg, jcfg), TOL)


def test_rotation_invariance():
    from scipy.spatial.transform import Rotation

    _, cfg, _, g, _, p = _case()
    out = equiformer.forward(p, g, cfg)
    r = torch.as_tensor(Rotation.random(random_state=5).as_matrix(),
                        dtype=torch.float32)
    out_rot = equiformer.forward(p, dict(g, positions=g["positions"] @ r.T),
                                 cfg)
    np.testing.assert_allclose(_np(out), _np(out_rot), rtol=2e-4, atol=2e-5)


def test_edge_chunking_invariance():
    _, cfg, _, g, _, p = _case()
    out = equiformer.forward(p, g, cfg)
    out_c = equiformer.forward(p, g, dataclasses.replace(cfg, edge_chunk=40))
    np.testing.assert_allclose(_np(out), _np(out_c), rtol=1e-5, atol=1e-6)
    # and the chunked gradients (each chunk checkpointed) equal the whole's
    _, grads = value_and_grad(equiformer.loss_fn)(p, g, cfg)
    _, grads_c = value_and_grad(equiformer.loss_fn)(
        p, g, dataclasses.replace(cfg, edge_chunk=40))
    for a, b in zip(leaves(grads), leaves(grads_c), strict=True):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5,
                                   atol=1e-6 * float(b.abs().max()))
    with pytest.raises(ValueError, match="chunks"):
        equiformer.forward(p, g, dataclasses.replace(cfg, edge_chunk=50))


def test_big_graphs_checkpoint_whole_layers(monkeypatch):
    """Above 1M edges each layer is checkpointed (and each chunk inside
    it); the gradients equal the unchecked run's."""
    _, cfg, _, g, _, p = _case(n_layers=3)
    _, want = value_and_grad(equiformer.loss_fn)(p, g, cfg)
    monkeypatch.setattr(equiformer, "BIG_GRAPH_EDGES", E - 1)
    from torch.utils import checkpoint as ckpt

    calls = []
    orig = ckpt.checkpoint

    def count(fn, *a, **k):
        calls.append(fn.__name__)
        return orig(fn, *a, **k)

    monkeypatch.setattr(ckpt, "checkpoint", count)
    _, got = value_and_grad(equiformer.loss_fn)(p, g, cfg)
    assert calls.count("_layer") == 3
    for a, b in zip(leaves(got), leaves(want), strict=True):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5,
                                   atol=1e-6 * float(b.abs().max()))


# -- configs, parameters and the workload ------------------------------------

def test_config_params_and_specs_match_jax():
    jarch, arch = jax_get_arch("equiformer-v2"), get_arch("equiformer-v2")
    assert (arch.name, arch.family) == (jarch.name, jarch.family)
    for jc, c in ((jarch.config, arch.config),
                  (jarch.smoke_config, arch.smoke_config)):
        want = dataclasses.asdict(jc)
        for field in convert.DROPPED_MODEL_FIELDS:
            want.pop(field, None)
        assert dataclasses.asdict(c) == want
        assert convert.equiformer_config_from(jc) == c
        assert c.n_params() == jc.n_params()
        got = params.tree_leaves(equiformer.equiformer_param_specs(c))
        want = jax.tree.leaves(jax_eq.equiformer_param_specs(jc),
                               is_leaf=jax_params.is_spec)
        assert [(tuple(s.shape), s.logical, s.init) for s in got] == [
            (tuple(s.shape), s.logical, s.init) for s in want]
    assert arch.config.n_params() == 35_271_809
    for s, js in zip(arch.shapes, jarch.shapes, strict=True):
        for name in ("equiformer-v2", "gin-tu", "gatedgcn"):
            want = dataclasses.asdict(jax_gnn_common._specialize(
                jax_get_arch(name).config, js))
            for field in convert.DROPPED_MODEL_FIELDS:
                want.pop(field, None)
            assert dataclasses.asdict(gnn_common._specialize(
                get_arch(name).config, s)) == want
        for pos in (False, True):
            for mult in (1, 262_144):
                got = gnn_common.graph_input_specs(s, with_positions=pos,
                                                   edge_mult=mult)
                want = jax_gnn_common.graph_input_specs(
                    js, with_positions=pos, edge_mult=mult)
                assert sorted(got) == sorted(want)
                for k in want:
                    assert got[k].device.type == "meta"
                    assert tuple(got[k].shape) == want[k].shape, k
                    assert str(got[k].dtype).split(".")[-1] == str(
                        want[k].dtype), k


@pytest.mark.parametrize("name", ["equiformer-v2", "gin-tu"])
def test_gnn_workload_step_matches_jax(name):
    """One step of ``gnn_workload(...).fn`` against the JAX package's on a
    one-device CPU mesh: loss, params, m and v; and the stand-ins and
    model flops of every shape."""
    is_eq = name == "equiformer-v2"
    shape = gnn_common.GNNShape("tiny", N, E, F_IN, 1 if is_eq else 4,
                                n_graphs=4 if is_eq else 0)
    jshape = jax_gnn_common.GNNShape(*dataclasses.astuple(shape))
    mesh = _one_device_mesh()
    jw = jax_gnn_common.gnn_workload(jax_get_arch(name).smoke_config,
                                     jshape, mesh)
    w = gnn_common.gnn_workload(get_arch(name).smoke_config, shape, None)
    assert (w.name, w.kind, w.model_flops) == (jw.name, jw.kind,
                                               jw.model_flops)
    kw = dict(n_nodes=N, n_edges=E, d_feat=F_IN,
              n_classes=shape.n_classes, n_graphs=shape.n_graphs,
              with_positions=is_eq, seed=11)
    jg = jax_graph_data.random_graph_batch(**kw)
    g = graph_data.random_graph_batch(**kw, device="cpu")
    jcfg = jax_gnn_common._specialize(jax_get_arch(name).smoke_config,
                                      jshape)
    jp = jax_params.tree_init(
        jax.random.PRNGKey(1), jax_eq.equiformer_param_specs(jcfg) if is_eq
        else jax_gnn.gnn_param_specs(jcfg))
    p = convert.params_from_numpy(jp, "cpu")
    jp2, jo2, jm = jax.jit(jw.fn)(jp, jax_optimizer.init_state(jp), jg)
    p2, o2, m = w.fn(p, optimizer.init_state(p), g)
    _close(m["loss"], jm["loss"], TOL)
    _hold_tree(o2.mu, jo2.mu)
    _hold_tree(o2.nu, jo2.nu)
    _hold_tree(p2, jp2, STEP_TOL)
    for s, js in zip(gnn_common.GNN_SHAPES, jax_gnn_common.GNN_SHAPES):
        jw = jax_gnn_common.gnn_workload(jax_get_arch(name).config, js, mesh)
        w = gnn_common.gnn_workload(get_arch(name).config, s, None)
        assert w.model_flops == jw.model_flops
        assert [tuple(x.shape) for x in leaves(w.in_sds)] == [
            tuple(x.shape) for x in jax.tree.leaves(jw.in_sds)]


@pytest.mark.parametrize("name", ["gin-tu", "gat-cora", "gatedgcn"])
def test_gnn_remat_gives_the_same_grads(name, monkeypatch):
    """A GNN with ``remat=True`` checkpoints each layer body (the segment
    plan made once, outside) and gives bitwise the gradients of
    ``remat=False``."""
    cfg = gnn_common._specialize(
        get_arch(name).smoke_config,
        gnn_common.GNNShape("tiny", N, E, F_IN, 4))
    g = graph_data.random_graph_batch(n_nodes=N, n_edges=E, d_feat=F_IN,
                                      n_classes=4, seed=11, device="cpu")
    p = params.tree_init(gnn.gnn_param_specs(cfg),
                         generator=torch.Generator().manual_seed(0),
                         device="cpu")
    assert not cfg.remat
    _, want = value_and_grad(gnn.loss_fn)(p, g, cfg)
    from repro_torch.kernels.segment_spmm import ops

    plans = []
    orig = ops.plan
    monkeypatch.setattr(ops, "plan", lambda *a, **k: plans.append(
        k.get("count", "segment_plan")) or orig(*a, **k))
    loss, got = value_and_grad(gnn.loss_fn)(
        p, g, dataclasses.replace(cfg, remat=True))
    assert plans.count("segment_plan") == 1
    for a, b in zip(leaves(got), leaves(want), strict=True):
        assert torch.equal(a, b)
