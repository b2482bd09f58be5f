"""arks_tpu_torch: the PyTorch/CUDA port of the arks-tpu serving stack.

The JAX package ``arks_tpu`` is the reference; this package mirrors its
layout (``models/``, ``ops/``, ``engine/``, ``server/``) so every function
has a counterpart of the same name.  It imports torch and never jax or
anything of ``arks_tpu``.  The TPU's Pallas kernels on the served path are
hand-written CUDA C++ kernels under ``csrc/``, built with nvcc at first use
(``ops/_kernels.py``); each has a plain PyTorch version beside it, which
is what runs for tensors on the CPU.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(``arks_tpu_torch.device.resolve_device``).
"""

__version__ = "0.1.0"
