"""Plain PyTorch version of the segment scatter-sum kernel (B4).

The semantics of ``jax.ops.segment_sum`` over 2-D values plus a row mask:
rows whose id lies outside ``[0, num_segments)`` (negative ones too) or
whose mask is false are dropped; the rest are summed into their segment in
fp32 and the result is cast to the input dtype, as the TPU kernel does.
A non-finite row reaches its own segment only.
"""

from __future__ import annotations

import torch


def check_inputs(values, segment_ids, num_segments: int, mask=None) -> None:
    if values.dim() != 2:
        raise ValueError(f"values has shape {tuple(values.shape)}, "
                         "expected [E, D]")
    e = values.shape[0]
    if segment_ids.shape != (e,):
        raise ValueError(f"segment_ids has shape {tuple(segment_ids.shape)}"
                         f", expected ({e},)")
    if mask is not None and mask.shape != (e,):
        raise ValueError(f"mask has shape {tuple(mask.shape)}, "
                         f"expected ({e},)")
    if num_segments < 0:
        raise ValueError("num_segments must be >= 0")


def kept_ids(segment_ids, num_segments: int, mask=None):
    """The ids with every dropped row (out of range, or masked) set to the
    sentinel ``num_segments``."""
    keep = (segment_ids >= 0) & (segment_ids < num_segments)
    if mask is not None:
        keep &= mask.to(torch.bool)
    return torch.where(keep, segment_ids, num_segments)


def scatter_sum(values, segment_ids, num_segments: int, mask=None, *,
                acc_dtype=torch.float32):
    """Sum rows of ``values [E, D]`` into ``num_segments`` rows.

    Masked-out and out-of-range rows go to one extra row that is cut off
    (``index_add_`` into a buffer of ``num_segments + 1`` rows of
    ``acc_dtype``, fp32 as the kernel accumulates).
    """
    check_inputs(values, segment_ids, num_segments, mask)
    ids = kept_ids(segment_ids.long(), num_segments, mask)
    out = torch.zeros((num_segments + 1, values.shape[1]), dtype=acc_dtype,
                      device=values.device)
    out.index_add_(0, ids, values.to(acc_dtype))
    return out[:num_segments].to(values.dtype)


def segment_sum(values, rows, sorted_ids, num_segments: int):
    """Sum ``values[rows[r]]`` into segment ``sorted_ids[r]`` for every
    sorted position ``r`` (the kernel's contract over a segment plan):
    ``index_add_`` into fp32 (fp64 for float64 values, which the kernel
    does not take: a float64 reference run), positions with an id
    outside ``[0, num_segments)`` dropped.  With ``rows`` the plan's
    stable permutation each segment adds its rows in input order, as
    :func:`scatter_sum` does."""
    if values.dim() != 2:
        raise ValueError(f"values has shape {tuple(values.shape)}, "
                         "expected [R, D]")
    acc = torch.promote_types(values.dtype, torch.float32)
    ids = kept_ids(sorted_ids.long(), num_segments)
    out = torch.zeros((num_segments + 1, values.shape[1]), dtype=acc,
                      device=values.device)
    out.index_add_(0, ids, values[rows.long()].to(acc))
    return out[:num_segments].to(values.dtype)
