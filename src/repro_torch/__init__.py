"""repro_torch: AdaPT serving and the AdaPT-SGD training step, ported to
PyTorch and CUDA (H100).

A second package beside ``repro`` (the JAX/Pallas reference). It imports
``torch`` and never ``jax`` or ``repro``; its public functions keep the
reference's names, argument order and array layouts.
"""
__version__ = "0.1.0"
