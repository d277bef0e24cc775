"""SegmentPlan: the sorted order of a fixed key array, for segment sums.

Port of ``tabmat_tpu/ops/segments.py``.  Every ``out[key[i]] += v[i]`` of
the categorical layers (tmv, sandwich diagonals, cat×dense and cat×cat
cross cells) runs through a plan built once per key array, on the plan's
own device, by one stable sort of keys that are already there:

- ``perm`` (E,) int32, or int64 past 2³¹ − 1 keys: the rows whose key is
  valid, stably sorted by key;
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

from .. import _trace
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
        """Segment sum of ``values`` (n,) → (num_segments,), or row-wise of
        ``values`` (n, m) → (num_segments, m)."""
        return segsum_kernel.segsum(values, self)


def build_plan(keys, num_segments: int, device) -> SegmentPlan:
    """Build a SegmentPlan for ``keys`` on ``device``: one stable sort there.

    ``keys`` is an integer tensor on ``device`` (a categorical's codes are
    kept there), or a host array or tensor, uploaded once.  Keys outside
    ``[0, num_segments)`` fall in no segment: they are mapped to
    ``num_segments``, which sorts after every valid key.  A stable sort has
    one answer, so the plan is the JAX package's host argsort
    (``tabmat_tpu/_native``) bit for bit, its invalid keys dropped.  Every
    sorted plan of the port is built here: the categoricals', their
    crosses', the sparse pair and (code, column) plans and the mixed
    design's.
    """
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with _trace.span("plan.build"):
        _trace.count("plans_built")
        if torch.is_tensor(keys) and keys.device == device:
            _trace.count("plans_from_device_keys")
        keys = torch.as_tensor(keys)
        key_dtype = torch.int32 if num_segments < 2**31 else torch.int64
        if keys.dtype not in (key_dtype, torch.int64):
            keys = keys.long()
        keys = keys.to(device)
        n = keys.shape[0]
        positions = torch.int64 if n > 2**31 - 1 else torch.int32
        keys = torch.where((keys >= 0) & (keys < num_segments), keys, num_segments)
        keys = keys.to(key_dtype)
        sorted_keys, order = torch.sort(keys, stable=True)
        bounds = torch.searchsorted(
            sorted_keys,
            torch.arange(num_segments + 1, dtype=key_dtype, device=device),
            out_int32=positions == torch.int32,
        )
        # the valid keys' count, on the host: the one wait of a build
        return SegmentPlan(order[: int(bounds[-1])].to(positions), bounds, n)


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
