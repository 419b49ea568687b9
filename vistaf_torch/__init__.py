"""vistaf_torch: PyTorch + CUDA port of the VISTAF force, temperature,
multimodal and streaming pipelines.

The JAX package beside it is the reference this package is checked
against.  Layout mirrors it module by module (``config``, ``ops``, ``ftp``,
``calib``, ``pipelines``, ``parallel``, ``temperature``, ``runner`` (the CLI,
``python -m vistaf_torch.runner.cli``, and the session runner), ``utils``); the
Pallas kernels become the hand-written Hopper kernels in ``kernels`` (Python
wrappers) and ``csrc`` (CUDA sources).  Every kernel wrapper dispatches on the tensor's device
only: a CUDA tensor launches the kernel, a CPU tensor runs the plain
PyTorch version beside it, anything else raises.
"""

__version__ = "0.1.0"


def use_full_fp32() -> None:
    """Run float32 matmuls and convolutions in full float32 on the GPU.
    The blurs are banded matmuls whose association order is part of the
    accuracy contract; TF32 would round every one of them."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
