"""Start a world of ranks on this host and run one function in each.

The JAX package's tests and ``__graft_entry__.py`` split the host CPU into
8 virtual devices under one controller.  The port's ranks are processes, as
in any PyTorch program: ``torchrun`` starts them on a multi-card node, and
:func:`run` starts them here, from Python::

    results = run(fn, 8, "gloo", "cpu", *args)

Each rank is a process of the ``spawn`` start method that joins a process
group through a ``file://`` store in a fresh temporary directory (no port,
no network), calls ``fn(device, *args)``, and sends back what it returns,
which must pickle.  ``fn`` is pickled by its import path, so it lives in a
module that a fresh interpreter can import.  ``backend`` is ``"nccl"``
across cards or ``"gloo"``: with CPU tensors, or with CUDA tensors when
several ranks share one card.
"""

import os
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(rank: int, world_size: int, backend: str, device, store: str, results,
               fn, args) -> None:
    try:
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
        dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                                world_size=world_size)
        try:
            out = fn(device, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def run(fn, world_size: int, backend: str = "gloo", device=None, *args, timeout: float = 600.0):
    """Run ``fn(device, *args)`` in ``world_size`` ranks; return the list of
    their results, by rank.

    ``device`` is what each rank passes to ``make_mesh``: None for a card,
    ``"cpu"`` for the CPU.  Raises ``RuntimeError`` with the rank's
    traceback when a rank raises, exits with another code than 0 or the
    ranks take longer than ``timeout`` seconds; the other ranks are ended
    then, since they may wait in a collective for the one that failed.
    """
    ctx = mp.get_context("spawn")
    results = ctx.SimpleQueue()
    tmp = tempfile.mkdtemp(prefix="tabmat_torch_world_")
    store = os.path.join(tmp, "store")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world_size, backend, device, store, results, fn, args))
             for r in range(world_size)]
    out, failure = {}, None
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(out) < world_size and failure is None:
            if not results.empty():
                rank, ok, value = results.get()
                if ok:
                    out[rank] = value
                else:
                    failure = f"rank {rank} raised:\n{value}"
                continue
            dead = [r for r, p in enumerate(procs)
                    if r not in out and p.exitcode not in (None, 0) and results.empty()]
            if dead:
                failure = f"rank {dead[0]} exited with code {procs[dead[0]].exitcode}"
            elif time.monotonic() > deadline:
                failure = f"the ranks took longer than {timeout} s"
            else:
                time.sleep(0.01)
    finally:
        for p in procs:
            if failure is not None and p.is_alive():
                p.kill()
            p.join(timeout=60)
        shutil.rmtree(tmp, ignore_errors=True)
    if failure is not None:
        raise RuntimeError(failure)
    bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"ranks exited with codes {bad}")
    return [out[r] for r in range(world_size)]
