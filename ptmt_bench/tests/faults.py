"""Faults planted under the timed path, for the test that sees ``correct``
come out false, and the control switched on at the tiny sizes.

The faults are the entry's: each entry has a module of its own,
``entry_faults/<entry>.py``, found by the entry's name in a drop-in root
first, then under ``ptmt_bench/tests``.  It holds ``BREAKS``, for each
fault it plants the checks that fault has to break, and
``plant(fault)``, which plants it in the process about to run.
"""

from __future__ import annotations

from pathlib import Path

from .kit import pieces

#: the faults every cell is run with: a one-rank step's (the exchange
#: between chips is the identity there)
FAULTS = ("answer", "half", "unchanged")


def entry_module(entry: str, root: Path | None = None):
    """The fault module of ``entry``; raises, naming the file to add,
    where it has none."""
    try:
        return pieces(root).module("entry_faults", entry)
    except FileNotFoundError:
        raise FileNotFoundError(
            f"entry {entry!r} has no fault module: add "
            f"ptmt_bench/tests/entry_faults/{entry}.py"
            + (f" or {root}/entry_faults/{entry}.py" if root else "")
        ) from None


def plant(registry, cell: str, fault: str | None,
          root: Path | None = None) -> None:
    """Plant ``fault`` of the entry that ``cell``'s configuration
    drives."""
    if fault is None:
        return
    entry = registry.config(registry.cell(cell)["config"])["entry"]
    module = entry_module(entry, root)
    if fault not in module.BREAKS:
        raise ValueError(f"entry_faults/{entry}.py plants no fault "
                         f"{fault!r}")
    module.plant(fault)


def control(registry) -> None:
    """Make the registry hand out each configuration with its control
    switched on, as ``control.py`` does."""
    from ptmt_bench.control import merged

    config = registry.config

    def with_control(name):
        c = config(name)
        return merged(c, {k: v for k, v in c["control"].items()
                          if k != "why"})

    registry.config = with_control
