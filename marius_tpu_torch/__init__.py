"""marius_tpu_torch — the PyTorch/CUDA port of marius_tpu for NVIDIA Hopper.

A second package beside ``marius_tpu`` (the JAX/TPU reference, which stays
as it is). Module paths mirror the JAX package's, so each module's
counterpart is found under the same name. Plain tensor code is PyTorch; the
TPU's Pallas kernels are rewritten by hand in CUDA C++ for ``sm_90a``
(``csrc/``), built with nvcc at first use. Entry points run on the GPU unless
the caller asks for the CPU. This package imports neither JAX nor marius_tpu.
"""

__version__ = "0.1.0"

import torch as _torch

# MKL's vector math, which torch's CPU sqrt, exp, log, tanh and the like
# call, sets itself up on its first call in a process. When that first call
# comes from several OpenMP threads at once (an elementwise op over 32,768
# elements or more, on a warm thread pool), one thread can return its whole
# chunk at about 12 bits of precision. A first call on one thread sets it up
# safely for every later call.
_torch.sqrt(_torch.ones(64))
