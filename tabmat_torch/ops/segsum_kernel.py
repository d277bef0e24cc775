"""The hand-written CUDA segment sum over a sorted plan, and its plain version.

Kernel: ``tabmat_torch/csrc/segsum.cu``, instantiated for ``double`` and
``float``::

    out[s, j] = Σ_{bounds[s] ≤ t < bounds[s+1]} values[perm[t], j]

It replaces ``tabmat_tpu/ops/pallas_segsum.py:_segsum_kernel`` (W ≤ 2^14)
and ``tabmat_tpu/ops/pallas_segsum_bucketed.py:_segsum_bucketed_kernel``
(512 < W ≤ 2^17), which formed the sums as one-hot matrix products of exact
bf16 slices because the TPU gathers slowly and has no f64.  Here it covers
any number of segments W and takes the :class:`~.segments.SegmentPlan`
built once per matrix: the categorical tmv and sandwich diagonal (m = 1),
the cat×dense cross cells (m = dense width) and the cat×cat cells (W = the
product of the two widths, 10^6 at 1000 × 1000).

Bound: the bytes (perm, one gathered value per element, bounds, the output).
Segment lengths range from 1 to n, so the kernel balances over the sorted
elements: each thread sums the runs inside a chunk of ``CHUNK`` elements,
and one warp per segment that spans chunks joins the chunk partials in a
fixed order.  No atomics: a result repeats bit for bit, and an assembled
Hessian is exactly symmetric.

The wrapper takes the plain version only for a tensor on the CPU; for a
CUDA tensor it launches the kernel or raises.
"""

import ctypes

import torch

# Launch counts by instantiation: each rises by one where that kernel is
# launched, nowhere else.
launches = {"segsum<double>": 0, "segsum<float>": 0}

_NAMES = {torch.float64: "segsum<double>", torch.float32: "segsum<float>"}
_SYMBOLS = {"segsum<double>": "tabmat_segsum_f64", "segsum<float>": "tabmat_segsum_f32"}
_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
]

# Must match csrc/segsum.cu.
CHUNK = 16

_lib = None


def reset_launch_counts() -> None:
    """Set every launch count to 0."""
    for name in launches:
        launches[name] = 0


def spanning_segments(bounds: torch.Tensor) -> torch.Tensor:
    """int32 ids of the segments whose elements lie in more than one
    ``CHUNK``-element chunk: the kernel's second pass joins exactly these."""
    start, end = bounds[:-1].long(), bounds[1:].long()
    spans = (end > start) & (start // CHUNK != (end - 1) // CHUNK)
    return torch.nonzero(spans).flatten().to(torch.int32)


def segsum_plain(values: torch.Tensor, perm: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch segment sum: gather through ``perm``, ``index_add_`` by
    segment id.  ``values`` (n,) or (n, m) → (W,) or (W, m)."""
    num_segments = bounds.shape[0] - 1
    seg = torch.repeat_interleave(
        torch.arange(num_segments, dtype=torch.int32, device=values.device),
        bounds[1:] - bounds[:-1],
        output_size=perm.shape[0],
    )
    out = torch.zeros((num_segments,) + tuple(values.shape[1:]), dtype=values.dtype,
                      device=values.device)
    return out.index_add_(0, seg, values.index_select(0, perm))


def segsum(values: torch.Tensor, plan) -> torch.Tensor:
    """Segment sum of ``values`` (n,) or (n, m) by ``plan`` → (W,) or (W, m).

    CPU tensors take :func:`segsum_plain`.  CUDA tensors launch the kernel;
    ``values`` must be contiguous and on the plan's device.
    """
    if not torch.is_tensor(values):
        raise TypeError("values must be a torch tensor")
    if values.ndim not in (1, 2):
        raise ValueError(f"values must have rank 1 or 2, got {values.ndim}")
    if values.dtype not in _NAMES:
        raise TypeError(f"values must be float64 or float32, got {values.dtype}")
    if values.shape[0] != plan.n_rows:
        raise ValueError(f"values has {values.shape[0]} rows, the plan {plan.n_rows}")
    if values.device != plan.perm.device:
        raise ValueError(f"values is on {values.device}, the plan on {plan.perm.device}")
    if values.device.type == "cpu":
        return segsum_plain(values, plan.perm, plan.bounds)
    if values.device.type != "cuda":
        raise ValueError(f"the kernels run on cpu or cuda tensors, got {values.device}")
    if not values.is_contiguous():
        raise ValueError("the CUDA segment sum needs contiguous values")
    m = 1 if values.ndim == 1 else values.shape[1]
    W, E = plan.num_segments, plan.perm.shape[0]
    if E == 0 or m == 0:
        return torch.zeros((W,) + tuple(values.shape[1:]), dtype=values.dtype,
                           device=values.device)
    name = _NAMES[values.dtype]
    chunks = -(-E // CHUNK)
    with torch.cuda.device(values.device):
        lib = _library()
        out = torch.empty((W,) + tuple(values.shape[1:]), dtype=values.dtype,
                          device=values.device)
        parts = torch.empty((2, chunks, m), dtype=values.dtype, device=values.device)
        spanning = plan.spanning
        err = getattr(lib, _SYMBOLS[name])(
            values.data_ptr(), plan.perm.data_ptr(), plan.bounds.data_ptr(),
            spanning.data_ptr(), W, E, m, spanning.shape[0],
            out.data_ptr(), parts[0].data_ptr(), parts[1].data_ptr(),
            torch.cuda.current_stream(values.device).cuda_stream,
        )
        from .. import _build

        _build.raise_on(lib, err, "segsum.cu kernel")
        launches[name] += 1
    return out


def _library():
    """The built ``segsum.cu`` with its C functions typed (built at first use)."""
    global _lib
    if _lib is None:
        from .. import _build

        _lib = _build.bind("segsum", {symbol: _ARGTYPES for symbol in _SYMBOLS.values()})
    return _lib
