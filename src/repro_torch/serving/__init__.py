"""Serving on the port: the multi-tenant motif service and its cluster
layer.  The LM serving engine is a later slice (ROADMAP slice 9)."""

from . import cluster, motif

__all__ = ["cluster", "motif"]
