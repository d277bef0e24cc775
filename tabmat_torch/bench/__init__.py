"""The benchmark CLI of tabmat_torch: the reference's designs timed on the
card against numpy/scipy on the host (``python -m tabmat_torch.bench.main``).

Port of ``tabmat_tpu/bench/``.  ``tabmat_torch/__init__.py`` does not import
it, as the JAX package's does not import its own.
"""
