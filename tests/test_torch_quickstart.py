"""The port's quickstart (``repro_torch.examples.quickstart``) against the
JAX package's (``examples/quickstart.py``): the same graph and config,
the same counts, layout and tree, and the same printed lines but for the
engine-reuse line (the port's engine keeps no compile cache, so that
line prints its plan-cache hits and kernel launches instead).

The port's side runs on one torch thread, as
``tests/test_torch_engine_collegemsg.py`` explains.
"""

import os
import subprocess
import sys

import pytest
import torch

from repro.core import MiningConfig as JaxConfig
from repro.core import PTMTEngine as JaxEngine
from repro.data.synthetic_graphs import triadic_stream as j_triadic_stream
from repro_torch.examples import quickstart

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REUSE = "engine reuse: "


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(node):
    return sorted(node.transition_rows(), key=lambda r: -r[1])


def test_quickstart_matches_the_jax_engine(capsys):
    res = quickstart.main(device="cpu")
    assert "exactness check vs sequential baseline: PASS" in \
        capsys.readouterr().out
    graph = j_triadic_stream(5_000, 150, window=240, p_close=0.5, seed=7)
    jres = JaxEngine(JaxConfig(delta=120, l_max=4, omega=8)).discover(graph)
    assert res.counts == jres.counts
    assert (res.n_zones, res.overflow) == (jres.n_zones, jres.overflow)
    assert res.layout["kind"] == jres.layout["kind"]
    keys = ("label", "real_zones", "e_cap")
    assert [{k: b[k] for k in keys} for b in res.layout["buckets"]] == \
        [{k: b[k] for k in keys} for b in jres.layout["buckets"]]
    assert res.level_histogram() == jres.level_histogram()
    tree, jtree = res.tree(), jres.tree()
    root = tree.root.transition_rows()
    assert root == jtree.root.transition_rows()
    for code, _, _ in _rows(tree.root)[:4]:
        assert tree.node(code).transition_rows() == \
            jtree.node(code).transition_rows()


def test_quickstart_prints_the_jax_scripts_lines():
    port = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.examples.quickstart",
         "--device", "cpu"], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                 OMP_NUM_THREADS="1"))
    jax_out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", "quickstart.py")],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                 JAX_PLATFORMS="cpu"))
    out, err = port.communicate(timeout=300)
    assert port.returncode == 0, err
    assert jax_out.returncode == 0, jax_out.stderr
    lines = out.splitlines()
    jax_lines = jax_out.stdout.splitlines()
    assert "exactness check vs sequential baseline: PASS" in lines
    assert len(lines) == len(jax_lines)
    for a, b in zip(lines, jax_lines):
        if a.startswith(REUSE):
            assert b.startswith(REUSE)
            assert "1 zone-plan cache hit(s), 2 scan launch(es), " \
                   "2 fused run(s)" in a
        else:
            assert a == b


def test_quickstart_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quickstart.main()
