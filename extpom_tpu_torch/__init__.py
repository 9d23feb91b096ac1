"""PyTorch/CUDA port of the extpom-tpu sigma-coordinate ocean core.

The JAX package ``extpom_tpu`` is the reference this package is held
against; nothing here imports it (or JAX).  Plain tensor code is PyTorch;
the kernels that the JAX package wrote in Pallas for the TPU are hand-written
CUDA C++ under ``csrc/``, bound through ``ctypes`` (``kernels/``).

Dispatch is by the tensors' device: a CUDA tensor goes to the kernel, a CPU
tensor to the kernel's plain PyTorch version.  Entry points default to CUDA
and raise when no CUDA device exists; pass ``device="cpu"`` to run on the
CPU.
"""

from extpom_tpu_torch.core.config import Config  # noqa: F401
