"""spark_rapids_jni_tpu_torch — the PyTorch/CUDA port of spark_rapids_jni_tpu.

The JAX package ``spark_rapids_jni_tpu`` is the reference; this package
mirrors its module layout so every module here has a counterpart of the
same relative path there. Plain tensor code is PyTorch. Every Pallas
kernel of the reference that this port covers is a hand-written CUDA
kernel for Hopper (``csrc/``), built with ``nvcc`` at first use and bound
through ``ctypes`` (``ops/cuda_kernels.py``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU and without an explicit device they raise. On CPU tensors
each kernel wrapper runs its plain PyTorch version.

This package never imports ``jax`` nor any module of the reference.
"""

__version__ = "0.1.0"
