"""Readings that the limits of ``correct`` are set from: the program's
sound runs and its control, over many seeds in one process.

    python3 ptmt_bench/control.py --workload <cell> --seeds 11 12 13 \\
        --seconds 3 --variant both

``program`` runs the cell as committed; ``control`` runs it with the
configuration's ``control`` overrides, the program's own path that
breaks one guarantee the configuration states (a unique-code budget that
overflows).  Each run sets up,
warms up, runs a short window at the cell's own load and is compared
with the reference exactly as ``run.py`` compares it; one JSON line per
run, then a summary: the largest reading of the program and the least
of the control, per number.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[1]
sys.path[:0] = [p for p in (str(CHECKOUT), str(CHECKOUT / "src"))
                if p not in sys.path]

from ptmt_bench.registry import Registry  # noqa: E402
from ptmt_bench.run import cache_bytecode, card  # noqa: E402


def merged(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = (merged(out[k], v) if isinstance(v, dict)
                  and isinstance(out.get(k), dict) else v)
    return out


def reading(reg, cell: dict, *, seed: int, seconds: float, variant: str,
            device) -> dict:
    """One run's numbers compared, as ``run.py`` computes them."""
    config = reg.config(cell["config"])
    if variant == "control":
        config = merged(config, {k: v for k, v in config["control"].items()
                                 if k != "why"})
    traffic = reg.traffic(cell["traffic"])
    driver = reg.driver(traffic["driver"])
    session = reg.session(config, seed=seed, device=device, traced=False)
    session.setup()
    driver.warm(session, traffic)
    window = driver.run_window(session, traffic, seconds=seconds, seed=seed)
    session.free()
    numbers, info, _ = session.check(window.kept)
    return {"variant": variant, "seed": seed, "calls": window.completed,
            "failed": window.failed, **numbers, **info}


def main(argv=None, *, registry=None, device=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--variant", choices=("program", "control", "both"),
                    default="both")
    args = ap.parse_args(argv)
    cache_bytecode()
    reg = registry or Registry()
    cell = reg.cell(args.workload)
    if device is None:
        device = card(cell["chips"])
    variants = (("program", "control") if args.variant == "both"
                else (args.variant,))
    rows = []
    for seed in args.seeds:
        for variant in variants:
            rows.append(reading(reg, cell, seed=seed, seconds=args.seconds,
                                variant=variant, device=device))
            print(json.dumps(rows[-1]), flush=True)
    limits = reg.config(cell["config"])["limits"]
    summary = {}
    for name in limits:
        for variant, pick in (("program", max), ("control", min)):
            vals = [r[name] for r in rows if r["variant"] == variant
                    and r[name] is not None]
            if vals:
                summary[f"{name}.{variant}"] = pick(vals)
    print(json.dumps({"summary": summary, "limits": limits}), flush=True)
    return rows


if __name__ == "__main__":
    main()
