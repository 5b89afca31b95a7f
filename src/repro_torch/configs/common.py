"""Registry entries shared by all architecture configs."""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class ArchDef:
    """Registry entry: full config + reduced smoke config + shape table.

    The JAX package's entries also carry a dry-run workload function; that
    waits for ROADMAP slice 10 here.
    """

    name: str
    family: str                       # lm | gnn | recsys | mining
    config: Any
    smoke_config: Any
    shapes: tuple

    def shape(self, shape_name: str):
        return next(s for s in self.shapes if s.name == shape_name)
