"""gptq_tpu_torch: the PyTorch / CUDA (Hopper) port of gptq_tpu.

Module names mirror `gptq_tpu` so each piece has an obvious counterpart.
The package imports neither JAX nor `gptq_tpu`; the hand-written CUDA
kernels (`csrc/*.cu`) are built with `nvcc` at first use
(ops/_build.py), so importing any module here works on a machine without
CUDA.

Entry points take an explicit `device` (default "cuda") and raise when no
GPU is present; the CPU runs only when the caller asks for it, and then
every kernel wrapper uses its plain PyTorch twin.
"""

from gptq_tpu_torch.config import QuantConfig

__all__ = ["QuantConfig"]
