"""Row-sharded dense and categorical reductions: a rank's partial, one all-reduce.

Port of ``tabmat_tpu/parallel/shard_ops.py``.  The reference writes each op
under ``shard_map``: a shard's partial and one ``psum`` over ``dp``.  Here
each rank holds its rows (:func:`place_row_sharded`), runs the port's
kernels on them, and :func:`~.mesh.all_reduce` sums the (k, k), (k,) or
(W,) partials over ``dp``; ranks that share rows over ``mp`` hold the same
sum.

The reference's ``sharded_plane_sandwich`` runs the v4 Pallas kernel over a
row slab of the int8 plane cache, a TPU structure the port does not keep:
:func:`sharded_sandwich` takes its place, on the Hopper sandwich kernels.
"""

import numpy as np
import torch

from ..ops import dense_ops
from ..ops.segments import build_plan
from .mesh import all_reduce, shard_rows


def sharded_sandwich(X: torch.Tensor, d: torch.Tensor, mesh) -> torch.Tensor:
    """``X.T @ diag(d) @ X`` with ``X`` and ``d`` this rank's rows over
    ``dp``: the rank's sandwich through the width dispatch's kernel, then one
    (k, k) all-reduce."""
    return all_reduce(dense_ops.sandwich(X, d), mesh, "dp")


def sharded_transpose_matvec(X: torch.Tensor, v: torch.Tensor, mesh) -> torch.Tensor:
    """``X.T @ v`` with row-sharded operands; one (k,) all-reduce."""
    return all_reduce(dense_ops.transpose_matvec(X, v), mesh, "dp")


def sharded_segment_sum(values: torch.Tensor, codes: torch.Tensor, num_segments: int,
                        mesh) -> torch.Tensor:
    """Categorical reduction of row-sharded ``values`` by ``codes``.

    The rank sorts its codes into a :class:`~tabmat_torch.ops.segments.SegmentPlan`
    on its device (the reference argsorts inside its kernel), sums its rows
    through the segment-sum kernel, and one (W,) all-reduce adds the ranks.
    Codes outside ``[0, num_segments)`` fall in no segment.
    """
    plan = build_plan(codes, num_segments, values.device)
    return all_reduce(plan.sum(values.contiguous()), mesh, "dp")


def place_row_sharded(mesh, *arrays):
    """This rank's rows (sharded over ``dp``) of each array, on its device."""
    out = [shard_rows(a if torch.is_tensor(a) else np.asarray(a), mesh) for a in arrays]
    return out if len(out) > 1 else out[0]
