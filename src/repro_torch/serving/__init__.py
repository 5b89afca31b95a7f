"""Serving on the port: the multi-tenant motif service and its cluster
layer, and the LM serving engine (``serving.engine``)."""

from . import cluster, engine, motif

__all__ = ["cluster", "engine", "motif"]
