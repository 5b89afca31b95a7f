"""The port's batch discovery on the collegemsg-like dataset against the
JAX package's, and the mining CLI's ``--check-sequential`` on it: the two
largest cases of ``tests/test_torch_engine.py``, in a file of their own so
that a run that splits the tests by file runs them beside the rest.

Their inputs and assertions are those of ``test_torch_engine.py``.  The
port's side runs on one torch thread: with torch's default of one thread
per core, several test processes on one host make its OpenMP threads
wait on each other (measured on an 8-core host with six copies at once:
the port's ``discover`` took over 420 s a copy against 4.5-4.9 s on one
thread; the JAX package's side 13.6-17.0 s either way).
"""

import os
import subprocess
import sys

import pytest
import torch

from repro.core import MiningConfig as JaxConfig
from repro.core import PTMTEngine as JaxEngine
from repro.data import synthetic_graphs as j_graphs
from repro_torch.core import MiningConfig, PTMTEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_STATS = ("bounds", "launches", "spill_retries", "merge_cap", "fold_chunk",
          "n_slots", "sweep_slots")


def _discover_both(graph, **cfg):
    j = JaxEngine(JaxConfig(backend="pallas", **cfg)).discover(graph)
    t = PTMTEngine(MiningConfig(backend="cuda", **cfg),
                   device="cpu").discover(graph)
    return j, t


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name,make,cfg", [
    ("collegemsg-like", lambda: j_graphs.make("collegemsg-like"),
     dict(delta=900, l_max=3, omega=6)),
])
def test_discover_counts_equal_jax(name, make, cfg):
    j, t = _discover_both(make(), **cfg)
    assert t.counts == j.counts
    assert (t.n_zones, t.e_cap, t.overflow) == (j.n_zones, j.e_cap,
                                                j.overflow)
    je, te = j.layout["execution"], t.layout["execution"]
    assert te["path"] == "fused_torch" and je["path"] == "fused_xla"
    assert {k: te[k] for k in _STATS} == {k: je[k] for k in _STATS}


def test_mine_cli_check_sequential_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.mine", "--device", "cpu",
         "--backend", "cuda", "--dataset", "collegemsg-like", "--delta",
         "900", "--l-max", "3", "--omega", "6", "--check-sequential"],
        capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "sequential TMC-analog (backend 'cuda')" in out.stdout
    assert "exact match: True" in out.stdout
