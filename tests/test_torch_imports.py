"""Import hygiene of the PyTorch port: it runs without JAX and without the
JAX package, and ``chip_smoke.py`` imports neither."""

import ast
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")

_PROBE = """
import importlib, pathlib, sys
root = pathlib.Path(sys.argv[1])
import repro_torch
for path in sorted(root.rglob("*.py")):
    rel = path.relative_to(root.parent).with_suffix("")
    name = ".".join(rel.parts)
    if name.endswith(".__init__"):
        name = name[: -len(".__init__")]
    importlib.import_module(name)
sys.path.insert(0, sys.argv[2])
import chip_smoke
chip_smoke.main  # noqa: B018 -- the script's own imports ran above
bad = sorted(m for m in sys.modules
             if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
print("LOADED", len(sys.modules), "BAD", bad)
"""


def _port_files():
    for dirpath, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_port_modules_import_without_jax_or_reference():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-c", _PROBE, PORT, ROOT], capture_output=True,
        text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_no_port_file_imports_jax_or_reference():
    offenders = []
    for path in [*_port_files(), os.path.join(ROOT, "chip_smoke.py")]:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "repro"):
                    offenders.append(f"{path}:{node.lineno}: {name}")
    assert not offenders, offenders


def test_chip_smoke_refuses_a_host_without_cuda():
    """Without a card the smoke script exits non-zero and prints no
    result line (this host's torch sees no CUDA device)."""
    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


#: the modules of slice 9's training half, each imported by the probe above
TRAINING_MODULES = ("repro_torch.models.equiformer",
                    "repro_torch.configs.equiformer_v2",
                    "repro_torch.launch.train",
                    "repro_torch.examples.train_lm")


def test_training_modules_are_port_modules():
    names = {".".join(os.path.relpath(p, os.path.dirname(PORT))[:-3]
                      .split(os.sep)) for p in _port_files()}
    assert set(TRAINING_MODULES) <= names


def test_slice_10_modules_are_probed_and_start_no_world():
    """The dry run's modules lie under the probed package, and importing
    them makes no process group (the fake world is made only by the dry
    run's ``run_cell``)."""
    for rel in ("launch/dryrun.py", "launch/analysis.py", "launch/mesh.py",
                "configs/ptmt.py", "models/sharding.py"):
        assert os.path.exists(os.path.join(PORT, rel)), rel
    code = ("import torch.distributed as dist\n"
            "import repro_torch.launch.dryrun, repro_torch.launch.mesh\n"
            "import repro_torch.configs.ptmt\n"
            "print('WORLD', dist.is_initialized())")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "WORLD False" in out.stdout


#: the quickstart and the last public names, each imported by the probe above
API_MODULES = ("repro_torch.examples.quickstart",
               "repro_torch.core.api",
               "repro_torch.kernels.zone_scan.ref",
               "repro_torch.core.planner")


def test_api_modules_are_port_modules():
    names = {".".join(os.path.relpath(p, os.path.dirname(PORT))[:-3]
                      .split(os.sep)) for p in _port_files()}
    assert set(API_MODULES) <= names


def test_package_exports_build_nothing_and_start_no_world():
    """Importing every package with its exports loads no kernel build
    module (the kernels build inside the call that launches them) and makes no
    process group."""
    code = ("import sys\n"
            "import torch.distributed as dist\n"
            "import repro_torch.core, repro_torch.data, repro_torch.models\n"
            "import repro_torch.serving, repro_torch.distributed\n"
            "import repro_torch.kernels.zone_scan\n"
            "import repro_torch.examples.quickstart\n"
            "print('BUILD', 'repro_torch.kernels._build' in sys.modules)\n"
            "print('WORLD', dist.is_initialized())")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "BUILD False" in out.stdout and "WORLD False" in out.stdout
