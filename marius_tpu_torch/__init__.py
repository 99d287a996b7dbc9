"""marius_tpu_torch — the PyTorch/CUDA port of marius_tpu for NVIDIA Hopper.

A second package beside ``marius_tpu`` (the JAX/TPU reference, which stays
as it is). Module paths mirror the JAX package's, so each module's
counterpart is found under the same name. Plain tensor code is PyTorch; the
TPU's Pallas kernels are rewritten by hand in CUDA C++ for ``sm_90a``
(``csrc/``), built with nvcc at first use. Entry points run on the GPU unless
the caller asks for the CPU. This package imports neither JAX nor marius_tpu.
"""

__version__ = "0.1.0"
