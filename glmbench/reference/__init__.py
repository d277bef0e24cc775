"""The plain reference of glmbench: NumPy, SciPy and pandas only.

It imports nothing of ``tabmat_torch``, of the JAX package or of JAX.
"""
