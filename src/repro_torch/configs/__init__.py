"""Architecture registry: ``get_arch(<id>)`` resolves here.

The archs ported so far: the five LM archs of ``models/transformer.py``,
the three GNN archs of ``models/gnn.py``, equiformer-v2
(``models/equiformer.py``) and the DCN-v2 recsys arch.
Each entry is a :class:`common.ArchDef` with a full config, a reduced
smoke config (CPU tests) and its shape set.  The JAX
package's other archs raise ``NotImplementedError`` naming the ROADMAP
slice that ports them.
"""

from __future__ import annotations

from .common import ArchDef  # noqa: F401

#: archs of the JAX package not ported yet -> the slice that ports them
UNPORTED = {
    "ptmt-mining": "slice 10 (cost analysis: the dry-run cells)",
}


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
    if name in reg:
        return reg[name]
    if name in UNPORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet: ROADMAP {UNPORTED[name]}")
    raise KeyError(f"unknown arch {name!r}; have {sorted(reg)}")


def arch_names() -> list[str]:
    return sorted(registry())


def lm_arch_names() -> list[str]:
    return sorted(a.name for a in registry().values() if a.family == "lm")
