"""repro_torch — PTMT (parallel motif-transition discovery) on PyTorch/CUDA.

The PyTorch port of the ``repro`` package, module for module at the same
relative paths.  It imports ``torch`` and ``numpy`` only.

Subpackages:
  core     the paper's algorithm (TZP + expansion + signed aggregation)
  kernels  hand-written CUDA kernels for Hopper, each beside its plain
           PyTorch version
  models   the model zoo's GNN layers and DCN-v2, with parameter trees
  configs  the registry of the ported model archs
  data     synthetic temporal graphs, graph batches and recsys batches
  obs      metrics, spans and timing helpers
  launch   the mining and motif-serving CLIs
  serving  the motif service and its cluster layer
  distributed  sharded mining over a ``torch.distributed`` DeviceMesh
  training AdamW, checkpoints, the training loop, the elastic mesh policy
  examples runnable examples (``python -m repro_torch.examples.<name>``)
"""

__version__ = "1.0.0"
