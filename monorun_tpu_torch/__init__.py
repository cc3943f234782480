"""MonoRUn in PyTorch: the serving path and the training step of
``monorun_tpu`` for CUDA GPUs.

A port of the JAX package that sits beside it in this repository. The
public functions keep the JAX package's channels-last (NHWC) layout and
its fixed-shape outputs with validity masks, so the two can be held
against each other on the same inputs. The RoIAlign family of Pallas
kernels becomes hand-written CUDA kernels (``csrc/``), the direct one
with a hand-written backward; everything else is plain PyTorch.

This package imports neither ``jax`` nor ``monorun_tpu``.
"""

__version__ = "0.1.0"
