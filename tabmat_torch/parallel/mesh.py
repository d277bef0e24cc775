"""Device meshes over ``torch.distributed``, and this rank's share of an array.

Port of ``tabmat_tpu/parallel/mesh.py``.  Every op of the library is a sum
over rows, so the multi-device path shards the rows over the ``dp`` axis:
each rank computes its rows' partial result, then one all-reduce of a small
(k,) or (k, k) tensor over the row axes gives every rank the whole.  Dense
columns may also shard over ``mp``.

The reference places arrays on a JAX ``Mesh`` from one controller.  The port
runs one process per rank, as PyTorch programs do (``torchrun``, or
:func:`~tabmat_torch.parallel.launch.run`): a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the default process group,
rank ``r`` at ``(r // mp, r % mp)`` as the reference's ``reshape(dp, mp)``,
and ``shard_rows``, ``replicate`` and ``shard_rows_cols`` return this rank's
slab on its device.  Slabs follow ``np.array_split``'s order, so any n
splits: the reference pads the shards, and the sums are the same.

The collectives are here, in one place: :func:`all_reduce` (sum, max, min)
over a list of mesh axes, innermost first.  The same code runs on NCCL
across cards, and on gloo with CPU tensors or with CUDA tensors (several
ranks sharing one card; NCCL refuses two ranks on one device).  Gloo stages
a CUDA tensor through the host inside its own all-reduce; nothing here moves
a tensor off its device.
"""

import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .._config import resolve_device

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


def _rank_device(device) -> torch.device:
    """This rank's device: ``device``, or the card the launcher gave the rank
    (``LOCAL_RANK``, else the global rank, modulo the cards on the host).
    Raises without a card unless ``device`` is the CPU."""
    if device is not None:
        return torch.device(device)
    resolve_device(None)  # raises without a card
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


def _device_mesh(shape: tuple, axis_names: Sequence[str], device):
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: start the ranks with tabmat_torch.parallel.launch.run or "
            "torchrun, and call torch.distributed.init_process_group first"
        )
    axis_names = tuple(axis_names)
    if len(axis_names) != len(shape):
        raise ValueError(f"{len(axis_names)} axis names for a {len(shape)}-d mesh")
    need, world = int(np.prod(shape)), dist.get_world_size()
    if need > world:
        raise ValueError(f"need {need} ranks, have {world}")
    device = _rank_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    # every axis takes the default group's backend: gloo stays gloo for CUDA
    # tensors (ranks that share a card), where DeviceMesh would pick NCCL
    backend = dist.get_backend()
    return DeviceMesh(
        device.type,
        torch.arange(need).reshape(shape),
        mesh_dim_names=axis_names,
        backend_override=tuple((backend, None) for _ in axis_names),
    )


def make_mesh(
    n_devices: Optional[int] = None,
    mp: int = 1,
    axis_names: Sequence[str] = ("dp", "mp"),
    device=None,
):
    """A (dp × mp) mesh over the first ``n_devices`` ranks (default: all).

    Every rank of the world calls it.  ``device`` is this rank's device:
    None means a CUDA card (raises without one), ``"cpu"`` the CPU.
    """
    if n_devices is None:
        n_devices = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices % mp != 0:
        raise ValueError(f"n_devices={n_devices} not divisible by mp={mp}")
    return _device_mesh((n_devices // mp, mp), axis_names, device)


def make_mesh_2level(
    dcn: int,
    dp: int,
    mp: int = 1,
    axis_names: Sequence[str] = ("dcn", "dp", "mp"),
    device=None,
):
    """Two-level mesh: ``dcn`` groups (hosts, or slices) of ``dp × mp`` ranks.

    Rows shard over ``("dcn", "dp")``.  :func:`all_reduce` over those axes
    sums within a group over ``dp`` first and then across groups over
    ``dcn``: a (k,) or (k, k) tensor is all that leaves a group.  Adjacent
    ranks share a group, as a launcher numbers the ranks of one host.
    """
    return _device_mesh((dcn, dp, mp), axis_names, device)


def mesh_device(mesh) -> torch.device:
    """The device of this rank's slabs."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    return torch.device(mesh.device_type, torch.cuda.current_device())


def axes_of(axes) -> tuple:
    """A mesh axis name or a tuple of them, as a tuple."""
    return tuple(axes) if isinstance(axes, (tuple, list)) else (axes,)


def _coordinate(mesh) -> dict:
    coord = mesh.get_coordinate()
    if coord is None:
        raise RuntimeError(f"rank {dist.get_rank()} is not in the mesh")
    return dict(zip(mesh.mesh_dim_names, coord))


def shard_index(mesh, axes) -> tuple:
    """``(index, count)`` of this rank's shard over ``axes`` (row-major, the
    reference's ``P(("dcn", "dp"))``)."""
    coord, sizes = _coordinate(mesh), dict(zip(mesh.mesh_dim_names, mesh.shape))
    index, count = 0, 1
    for axis in axes_of(axes):
        index, count = index * sizes[axis] + coord[axis], count * sizes[axis]
    return index, count


def split_range(n: int, index: int, count: int) -> tuple:
    """``(lo, hi)`` of part ``index`` of ``count`` of ``range(n)``, in
    ``np.array_split``'s order (the first ``n % count`` parts one longer)."""
    base, extra = divmod(n, count)
    lo = index * base + min(index, extra)
    return lo, lo + base + (index < extra)


def row_range(n: int, mesh, rows="dp") -> tuple:
    """``(lo, hi)``: this rank's rows of ``n`` sharded over ``rows``."""
    return split_range(n, *shard_index(mesh, rows))


def _on_device(x, device) -> torch.Tensor:
    t = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
    return t.to(device).contiguous()


def shard_rows(x, mesh, rows="dp") -> torch.Tensor:
    """This rank's rows of ``x`` (leading axis sharded over ``rows``) on its device."""
    lo, hi = row_range(x.shape[0], mesh, rows)
    return _on_device(x[lo:hi], mesh_device(mesh))


def replicate(x, mesh) -> torch.Tensor:
    """``x`` whole, on this rank's device."""
    return _on_device(x, mesh_device(mesh))


def shard_rows_cols(x, mesh) -> torch.Tensor:
    """This rank's block of ``x``: rows sharded over ``dp``, columns over ``mp``."""
    lo, hi = row_range(x.shape[0], mesh, "dp")
    c0, c1 = split_range(x.shape[1], *shard_index(mesh, "mp"))
    return _on_device(x[lo:hi, c0:c1], mesh_device(mesh))


def all_reduce(t: torch.Tensor, mesh, axes, op: str = "sum") -> torch.Tensor:
    """Reduce ``t`` in place over the mesh ``axes``, the last axis first
    (``("dcn", "dp")``: over ``dp``, then over ``dcn``), and return it.

    ``op`` is ``"sum"``, ``"max"`` or ``"min"``.  Each rank of a group ends
    with the same bits.  ``t`` must be contiguous.
    """
    if not t.is_contiguous():
        raise ValueError("all_reduce needs a contiguous tensor")
    for axis in reversed(axes_of(axes)):
        dist.all_reduce(t, op=_OPS[op], group=mesh.get_group(axis))
    return t


def gather_columns(X: torch.Tensor, cols: tuple, width: int, mesh, axis) -> torch.Tensor:
    """The (rows, width) matrix whose columns ``cols[0]:cols[1]`` are this
    rank's ``X`` and the rest those of the other ranks of ``axis``: an
    all-reduce of a zero-filled buffer (adding 0 is exact)."""
    full = X.new_zeros((X.shape[0], width))
    full[:, cols[0]:cols[1]] = X
    return all_reduce(full, mesh, axis)
