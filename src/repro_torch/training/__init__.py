"""Training substrate on PyTorch: AdamW on trees of tensors, checkpoints
in the JAX package's layout, the fault-tolerant loop and the elastic
mesh policy."""

from . import checkpoint, elastic, optimizer, train_loop, tree

__all__ = ["checkpoint", "elastic", "optimizer", "train_loop", "tree"]
