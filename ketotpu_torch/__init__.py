"""keto-tpu on PyTorch and CUDA: the port of the ``ketotpu`` check engine
to one NVIDIA H100.

The host side (API types, OPL, stores, the snapshot projection, the exact
oracle) is a copy of the JAX package's numpy code, so both packages build
byte-identical device tables.  The device side is torch tensors and
hand-written CUDA kernels (``csrc/``, loaded by ``kernels.py``).  This
package imports neither ``jax`` nor ``ketotpu``.
"""
