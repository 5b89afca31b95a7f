"""ptmt-mining — the paper's own workload as a first-class arch config.

Shapes are zone-batch geometries (zones x per-zone edge capacity); the step
is the full distributed discovery: each rank's zone expansion (B3 per
chunk of the rank's zones on ``backend="cuda"``) + the signed merge over
the mesh (:func:`repro_torch.distributed.mining.make_mine_fn`).  Paper
defaults: delta=600s, l_max=6, omega=20.  ``backend="cuda"`` comes from an
override (``dataclasses.replace``, as ``dryrun --override`` does).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import backends, encoding, planner
from repro_torch.distributed import mining

from .common import ArchDef, Workload


@dataclasses.dataclass(frozen=True)
class MiningConfig:
    name: str
    delta: int = 600
    l_max: int = 6
    omega: int = 20
    backend: str = "ref"
    out_cap: int = 65536
    merge_mode: str = "flat"   # "hierarchical": staged per-axis merge


CONFIG = MiningConfig(name="ptmt-mining")
SMOKE = MiningConfig(name="ptmt-mining-smoke", delta=30, l_max=3,
                     out_cap=1024)


@dataclasses.dataclass(frozen=True)
class MiningShape:
    name: str
    n_zones: int
    e_cap: int


MINING_SHAPES = (
    MiningShape("mine_1m", 2_048, 2_048),      # ~4M edge slots
    MiningShape("mine_dense", 1_024, 8_192),   # bursty regime (few big zones)
    MiningShape("mine_wide", 8_192, 1_024),    # sparse regime (many zones)
    MiningShape("mine_xl", 8_192, 4_096),      # ~34M edge slots
)


def mining_workload(cfg: MiningConfig, shape: MiningShape, mesh,
                    obs=None) -> Workload:
    """The SPMD mining step on every axis of ``mesh`` (a ``DeviceMesh`` of
    a process group: each rank mines its block of the zones); ``obs``
    (a live :class:`repro_torch.obs.Observability`) traces every step."""
    axes = tuple(mesh.mesh_dim_names)
    fn = mining.make_mine_fn(
        mesh, axes, delta=cfg.delta, l_max=cfg.l_max,
        backend=cfg.backend, out_cap=cfg.out_cap,
        merge_mode=cfg.merge_mode, obs=obs,
    )
    sds = mining.input_specs(shape.n_zones, shape.e_cap)
    in_sds = tuple(torch.empty(s, dtype=d, device="meta") for s, d in (
        sds["u"], sds["v"], sds["t"], sds["valid"], sds["signs"]))
    # The expansion sweep is integer work, not tensor-core flops: count
    # the per-(edge x candidate) vector ops as the useful-work yardstick.
    per_pair_ops = (cfg.l_max + 1) + 10
    vpu_ops = float(shape.n_zones) * shape.e_cap * shape.e_cap * per_pair_ops
    return Workload(
        name=f"{cfg.name}/{shape.name}", kind="mine", fn=fn,
        in_sds=in_sds, in_shardings=None,   # each rank slices its block
        model_flops=vpu_ops,
    )


def analytic_mining_terms(cfg: MiningConfig, shape: MiningShape,
                          n_chips: int) -> dict:
    """Roofline inputs for the mining sweep (an integer workload).

    Per zone the expansion does E steps, each a vector pass over the
    C = E candidate table (~(l_max+1)+10 int ops per pair).  The HBM
    traffic is the edge stream in + the final codes out + one table spill
    per zone (the JAX package's model, term for term).
    """
    z_local = max(shape.n_zones // n_chips, 1)
    per_pair = (cfg.l_max + 1) + 10
    ops = float(z_local) * shape.e_cap * shape.e_cap * per_pair
    limbs = encoding.n_limbs(cfg.l_max)
    state_bytes = (limbs + cfg.l_max + 1 + 4) * 4
    hbm = float(z_local) * (
        shape.e_cap * 16                      # u, v, t, valid in
        + shape.e_cap * (limbs + 1) * 4       # codes + lengths out
        + shape.e_cap * state_bytes           # one table spill
    )
    return {"ops_per_chip": ops, "hbm_bytes_per_chip": hbm}


def mining_rank_bytes(cfg: MiningConfig, shape: MiningShape,
                      n_chips: int) -> dict:
    """A rank's device memory for its block of the zones, by the
    executor's own model for the config's backend: the one-pass (legacy)
    aggregation the step's default executor runs (no zone chunk, no
    budget), and the all-gathered merge payload of ``out_cap`` rows per
    rank."""
    z_local = max(shape.n_zones // n_chips, 1)
    model = backends.get_backend(cfg.backend).mem_model
    scan = planner.legacy_peak_bytes(z_local, shape.e_cap, cfg.l_max,
                                     mem_model=model)
    cap = min(cfg.out_cap, z_local * shape.e_cap)
    row = 4 * (encoding.n_limbs(cfg.l_max) + 1)
    merge = 2 * n_chips * cap * row            # gathered rows + its sort
    return {"argument_bytes": 13 * z_local * shape.e_cap + 4 * z_local,
            "temp_bytes": scan + merge,
            "output_bytes": merge // 2}


ARCH = ArchDef(
    name="ptmt-mining", family="mining", config=CONFIG, smoke_config=SMOKE,
    shapes=MINING_SHAPES, workload_fn=mining_workload,
)
