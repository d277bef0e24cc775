"""SegmentPlan: the sorted order of a fixed key array, for segment sums.

Port of ``tabmat_tpu/ops/segments.py``.  Every ``out[key[i]] += v[i]`` of
the categorical layers (tmv, sandwich diagonals, cat×dense and cat×cat
cross cells) runs through a plan built once per key array on the host:

- ``perm`` (E,) int32: the rows whose key is valid, stably sorted by key;
- ``bounds`` (W + 1,) int32, or int64 for a sparse layout past 2³¹ − 1
  elements (``sparse_ops.bounds_dtype``): segment ``s`` is
  ``perm[bounds[s]:bounds[s+1]]``, with ``bounds[0] = 0`` and
  ``bounds[W] = E``.

Rows with a negative key (missing, ``drop_first``) are left out of
``perm``, so they fall in no segment.  The reference kept them in front of
``bounds[0]``; leaving them out lets plans stack into one (:func:`stack`).
``sum`` goes to the segment-sum kernel for a CUDA plan and to its plain
version for a CPU plan.  The reference differenced a cumsum at the bounds;
the port sums each segment directly, so no error grows with the prefix.
"""

import numpy as np
import torch

from .. import _native, _trace
from . import segsum_kernel


class SegmentPlan:
    """Reduction plan for a fixed integer key array, on one device.

    ``tables`` holds what a CUDA kernel derives from the layout alone, built
    on the card at its first call: the sparse product's tile starts, and the
    segment sum's row-tile layout (the elements sorted by tile of rows, a
    local row and a segment or slot each; ``segsum_kernel.tile_layout`` and
    ``slot_layout``).
    """

    def __init__(self, perm: torch.Tensor, bounds: torch.Tensor, n_rows: int):
        self.perm = perm
        self.bounds = bounds
        self.num_segments = bounds.shape[0] - 1
        self.n_rows = n_rows
        self.tables = {}

    @property
    def device(self) -> torch.device:
        return self.perm.device

    def sum(self, values: torch.Tensor) -> torch.Tensor:
        """Segment sum of ``values`` (n,) → (num_segments,)."""
        return segsum_kernel.segsum(values, self)

    def sum2d(self, values: torch.Tensor) -> torch.Tensor:
        """Row-wise segment sum of ``values`` (n, m) → (num_segments, m)."""
        return segsum_kernel.segsum(values, self)


def build_plan(keys: np.ndarray, num_segments: int, device) -> SegmentPlan:
    """Build a SegmentPlan for the host key array ``keys`` on ``device``.

    Keys outside ``[0, num_segments)`` fall in no segment.
    """
    with _trace.span("plan.build"):
        _trace.count("plans_built")
        keys = np.asarray(keys)
        perm, bounds = _native.counting_argsort(keys, num_segments)
        perm = perm[bounds[0] : bounds[-1]]
        bounds = bounds - bounds[0]
        return SegmentPlan(
            torch.as_tensor(perm, device=device),
            torch.as_tensor(bounds, device=device),
            len(keys),
        )


def stack(plans) -> SegmentPlan:
    """One plan whose segments are those of ``plans`` in turn, over the same
    rows: one segment sum then serves several categoricals at once.

    It stacks categorical plans (at most n elements each), whose bounds
    stay int32; no sparse layout reaches it.
    """
    offset = 0
    bounds = []
    for p in plans:
        assert p.bounds.dtype == torch.int32, "stack takes the categoricals' int32 plans"
        bounds.append(p.bounds[:-1] + offset)
        offset += p.perm.shape[0]
    assert offset <= np.iinfo(np.int32).max, "the stacked plan's bounds must fit int32"
    bounds.append(torch.full((1,), offset, dtype=torch.int32, device=plans[0].device))
    return SegmentPlan(
        torch.cat([p.perm for p in plans]), torch.cat(bounds), plans[0].n_rows
    )
