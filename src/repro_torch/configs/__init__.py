"""Architecture registry: ``get_arch(<id>)`` resolves here.

10 assigned architectures (5 LM, 4 GNN, 1 recsys) + the paper's own PTMT
mining configuration.  Each entry is a :class:`common.ArchDef` with a full
config (the dry run, and the card at cut depth), a reduced smoke config
(CPU tests), its shape set and its workload builder.
"""

from __future__ import annotations

from .common import ArchDef, Workload  # noqa: F401


def _registry() -> dict:
    from . import (  # local import: keep module import light
        arctic_480b,
        dcn_v2,
        equiformer_v2,
        gat_cora,
        gatedgcn,
        gemma3_1b,
        gin_tu,
        granite_8b,
        moonshot_v1_16b_a3b,
        ptmt,
        qwen2_72b,
    )

    archs = [
        granite_8b.ARCH,
        gemma3_1b.ARCH,
        qwen2_72b.ARCH,
        moonshot_v1_16b_a3b.ARCH,
        arctic_480b.ARCH,
        equiformer_v2.ARCH,
        gatedgcn.ARCH,
        gin_tu.ARCH,
        gat_cora.ARCH,
        dcn_v2.ARCH,
        ptmt.ARCH,       # the paper's own workload (mining)
    ]
    return {a.name: a for a in archs}


_CACHE: dict | None = None


def registry() -> dict:
    global _CACHE
    if _CACHE is None:
        _CACHE = _registry()
    return _CACHE


def get_arch(name: str) -> ArchDef:
    reg = registry()
    if name not in reg:
        raise KeyError(f"unknown arch {name!r}; have {sorted(reg)}")
    return reg[name]


def arch_names() -> list[str]:
    return sorted(registry())


def lm_arch_names() -> list[str]:
    return sorted(a.name for a in registry().values() if a.family == "lm")


def all_cells(include_mining: bool = True) -> list[tuple[str, str]]:
    """Every (arch, shape) dry-run cell — 40 assigned + 4 mining."""
    out = []
    for arch in registry().values():
        if arch.family == "mining" and not include_mining:
            continue
        for shape in arch.shapes:
            out.append((arch.name, shape.name))
    return sorted(out)
