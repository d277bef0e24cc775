"""Peak host memory (tracemalloc polling thread) and device memory.

Port of ``tabmat_tpu/bench/memory.py``.  The host side is the same protocol
as the reference (``benchmark/memory_tools.py:6-48``): a daemon thread
snapshots traced memory every millisecond and records the peak.  The device
side reads PyTorch's caching allocator: the kernel wrappers allocate their
scratch through torch (``csrc/`` has no ``cudaMalloc``), so these counts
see every byte the port holds on the card.  On the CPU the device readings
are None, as the JAX functions' are where the backend has no stats.
"""

import threading
import time
import tracemalloc

import torch


class MemoryPoller:
    """Poll tracemalloc in a background thread; use as a context manager."""

    def __init__(self, interval_s: float = 0.001):
        self.interval_s = interval_s
        self.max_memory = 0
        self._stop = False

    def _poll(self):
        while not self._stop:
            self.max_memory = max(self.max_memory, tracemalloc.get_traced_memory()[0])
            time.sleep(self.interval_s)

    def __enter__(self):
        tracemalloc.start()
        self.initial = tracemalloc.get_traced_memory()[0]
        self._thread = threading.Thread(target=self._poll, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop = True
        self._thread.join()
        self.max_memory = max(self.max_memory, tracemalloc.get_traced_memory()[0])
        tracemalloc.stop()
        return False


def track_peak_mem(fn, *args, **kwargs):
    """Run ``fn`` and return its peak traced host memory in bytes."""
    with MemoryPoller() as poller:
        fn(*args, **kwargs)
    return poller.max_memory - poller.initial


def _cuda(device):
    """``device`` as a CUDA device, or None for the CPU or without a card."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    return device if device.type == "cuda" else None


def device_memory_stats(device=None):
    """``torch.cuda.memory_stats`` of ``device`` (default: the current card),
    or None on the CPU."""
    device = _cuda(device)
    return None if device is None else torch.cuda.memory_stats(device)


def hbm_bytes_in_use(device=None):
    """Device bytes held by live tensors (``torch.cuda.memory_allocated``),
    or None on the CPU."""
    device = _cuda(device)
    return None if device is None else torch.cuda.memory_allocated(device)


def hbm_peak_bytes(fn, device=None):
    """Run ``fn`` and return the most device bytes it held above those in use
    when it started (``reset_peak_memory_stats``, ``max_memory_allocated``),
    or None on the CPU, where ``fn`` is not run."""
    device = _cuda(device)
    if device is None:
        return None
    torch.cuda.synchronize(device)
    before = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    fn()
    torch.cuda.synchronize(device)
    return torch.cuda.max_memory_allocated(device) - before
