"""Carry data, layouts, count tables, model weights and configs across
packages.

The state that crosses between the JAX package and this port is data
(edge streams), zone plans and layouts, count tables, the model zoo's
parameter trees, and configs.  These helpers take anything numpy can read
(numpy arrays, or the JAX package's arrays through ``np.asarray``) and
never import the JAX package.  ``ZonePlan.to_json``/``from_json`` already
round-trip plans.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from .aggregation import CodeCounts
from .config import MiningConfig
from .temporal_graph import TemporalGraph, from_edges
from .tzp import FusedZoneLayout

#: the JAX package's registry names -> their counterparts in this port
BACKEND_NAMES = {"pallas": "cuda", "xla": "torch"}

_LAYOUT_ARRAYS = ("u", "v", "t", "valid", "zone_id", "sign", "lo", "hi")


def graph_from_arrays(u, v, t) -> TemporalGraph:
    """A :class:`TemporalGraph` from edge arrays (sorted by time, stably)."""
    return from_edges(np.asarray(u), np.asarray(v), np.asarray(t))


def fused_layout_from_arrays(*, blk: int, kind: str = "bucketed",
                             bucket_shapes=(), n_zones: int = 0,
                             overflow: int = 0, bounds: str = "full",
                             **arrays) -> FusedZoneLayout:
    """A :class:`FusedZoneLayout` from its eight flat arrays
    (``u/v/t/valid/zone_id/sign/lo/hi``) plus its metadata."""
    missing = sorted(set(_LAYOUT_ARRAYS) - set(arrays))
    extra = sorted(set(arrays) - set(_LAYOUT_ARRAYS))
    if missing or extra:
        raise ValueError(f"layout arrays: missing {missing}, unknown {extra}")
    return FusedZoneLayout(
        **{k: np.asarray(arrays[k], np.int32) for k in _LAYOUT_ARRAYS},
        blk=int(blk), kind=kind,
        bucket_shapes=tuple(tuple(int(x) for x in s) for s in bucket_shapes),
        n_zones=int(n_zones), overflow=int(overflow), bounds=bounds,
    )


def counts_from_arrays(codes, counts, unique_mask, *,
                       device=None) -> CodeCounts:
    """A :class:`CodeCounts` of tensors from three arrays."""
    return CodeCounts(
        codes=torch.as_tensor(np.asarray(codes, np.int32), device=device),
        counts=torch.as_tensor(np.asarray(counts, np.int32), device=device),
        unique_mask=torch.as_tensor(np.asarray(unique_mask, bool),
                                    device=device),
    )


def counts_to_numpy(c) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(codes, counts, unique_mask)`` numpy arrays of a count table of
    either package."""
    host = lambda x: (x.detach().cpu().numpy() if torch.is_tensor(x)
                      else np.asarray(x))
    return host(c.codes), host(c.counts), host(c.unique_mask)


def config_from_json(data: str | bytes | dict) -> MiningConfig:
    """A :class:`MiningConfig` from either package's ``to_json``.

    Registry names of the JAX package map to their counterparts here
    (``pallas`` -> ``cuda``, ``xla`` -> ``torch``); every other field
    carries over as it is.
    """
    if not isinstance(data, dict):
        data = json.loads(data)
    data = dict(data)
    for field in ("backend", "fused_backend"):
        name = data.get(field)
        if name in BACKEND_NAMES:
            data[field] = BACKEND_NAMES[name]
    return MiningConfig.from_json(data)


def _tensor(x, device) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":      # ml_dtypes: torch reads the bits
        return torch.as_tensor(arr.view(np.uint16).copy(),
                               device=device).view(torch.bfloat16)
    return torch.as_tensor(arr.copy(), device=device)


def params_from_numpy(tree, device=None):
    """The port's parameter tree from the JAX package's (nested dicts of
    arrays): the same keys, shapes, layouts and dtypes, as tensors on
    ``device`` (default CUDA, raising without one)."""
    from .executor import resolve_device

    device = resolve_device(device)

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        return _tensor(node, device)

    return convert(tree)


#: config fields of the JAX package with no counterpart here: the kernel is
#: chosen by the tensors' device, ``unroll_scans`` is a compile-time knob
#: of the JAX package's dry run, no model drops out, and no code reads
#: ``eps_learnable`` (eps is always a parameter)
DROPPED_MODEL_FIELDS = ("use_pallas", "unroll_scans", "eps_learnable",
                        "dropout")


def _model_config(cls, cfg):
    data = dataclasses.asdict(cfg) if dataclasses.is_dataclass(cfg) \
        else dict(cfg)
    for field in DROPPED_MODEL_FIELDS:
        data.pop(field, None)
    return cls(**data)


def gnn_config_from(cfg):
    """The port's :class:`~repro_torch.models.gnn.GNNConfig` from the JAX
    package's ``GNNConfig`` (or its fields as a dict)."""
    from repro_torch.models.gnn import GNNConfig

    return _model_config(GNNConfig, cfg)


def equiformer_config_from(cfg):
    """The port's :class:`~repro_torch.models.equiformer.EquiformerConfig`
    from the JAX package's (or its fields as a dict)."""
    from repro_torch.models.equiformer import EquiformerConfig

    return _model_config(EquiformerConfig, cfg)


def dcn_config_from(cfg):
    """The port's :class:`~repro_torch.models.recsys.DCNConfig` from the
    JAX package's ``DCNConfig`` (or its fields as a dict)."""
    from repro_torch.models.recsys import DCNConfig

    return _model_config(DCNConfig, cfg)


def transformer_config_from(cfg):
    """The port's :class:`~repro_torch.models.transformer.TransformerConfig`
    from the JAX package's (or its fields as a dict), the dtype
    (``jnp.bfloat16``, ``jnp.float32``, any numpy-readable dtype) as the
    torch dtype of the same name."""
    from repro_torch.models.transformer import TransformerConfig

    data = dataclasses.asdict(cfg) if dataclasses.is_dataclass(cfg) \
        else dict(cfg)
    if not isinstance(data["dtype"], torch.dtype):
        data["dtype"] = getattr(torch, np.dtype(data["dtype"]).name)
    return _model_config(TransformerConfig, data)
