"""Data: synthetic temporal graphs, graph and recsys batches, LM token
pipelines.  Every module is numpy or torch only and builds nothing at
import."""

from . import lm_pipeline, recsys_pipeline, synthetic_graphs

__all__ = ["lm_pipeline", "recsys_pipeline", "synthetic_graphs"]
