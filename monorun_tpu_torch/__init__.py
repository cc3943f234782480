"""MonoRUn in PyTorch: the serving path of ``monorun_tpu`` for CUDA GPUs.

A port of the JAX package that sits beside it in this repository. The
public functions keep the JAX package's channels-last (NHWC) layout and
its fixed-shape outputs with validity masks, so the two can be held
against each other on the same inputs. The RoIAlign family of Pallas
kernels becomes one hand-written CUDA kernel (``csrc/roi_align.cu``);
everything else is plain PyTorch.

This package imports neither ``jax`` nor ``monorun_tpu``.
"""

__version__ = "0.1.0"
