"""Hand-written Hopper kernels and their plain PyTorch versions.

One module per kernel (``quantile_kernel``, ``inpaint_kernel``,
``ecc_loop_kernel``, ``polyfit_kernel``), each replacing one Pallas kernel
of the JAX package's ``pallas/``.  The CUDA sources live in ``vistaf_torch/csrc``;
they are compiled by ``nvcc`` into one shared library with a plain C
interface at first use, into ``vistaf_torch/_build`` (keyed on a hash of
the sources and flags), and loaded with ``ctypes``.

Every public wrapper dispatches on the device of its input tensor only: a
CUDA tensor launches the kernel (or raises), a CPU tensor runs the plain
version, anything else raises.  ``LAUNCHES[name]`` counts the kernel
launches of each wrapper; nothing else touches it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional

import torch

LAUNCHES: Dict[str, int] = {
    "masked_quantiles": 0,
    "inpaint_diffusion": 0,
    "ecc_loop_euclidean": 0,
    "robust_polyfit2d": 0,
}

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# --fmad=false keeps a*b + c as two roundings, as in the plain versions
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # x, mask, folded, out, batch, n, fractions (host), nq, levels, stream
    "vt_masked_quantiles": (_P, _P, _P, _P, _I, _I, _P, _I, _I, _P),
    # img, fill, out, scratch, batch, h, w, iters, stream
    "vt_inpaint_diffusion": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    # S, T, SM, mid, out, h, w, K, max_iters, eps, stall_patience, stream
    "vt_ecc_loop_euclidean": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P),
    # z, mask, out, h, w, ncoef, iters, resigma_iters, c, levels, stream
    "vt_robust_polyfit2d": (_P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P),
}

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    toolkit = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(toolkit):
        return toolkit
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME): the Hopper kernels are "
                       "built with the CUDA toolkit's nvcc")


def library_path() -> Path:
    """Path of the shared library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libvistaf_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/*.cu`` into the shared library unless it exists.
    Raises on any compiler failure; writes the compiler's output (``-Xptxas
    -v``: registers, shared memory and spills per kernel) beside it."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sources = [str(p) for p in sorted(CSRC_DIR.glob("*.cu"))]
    tmp = so.with_name(so.name + f".{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp),
                           *sources], capture_output=True, text=True)
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, so)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(args)
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def launch(fn_name: str, counter: str, device: torch.device, *args) -> None:
    """Call one launcher on ``device``'s current stream, count the launch,
    and raise on a non-zero ``cudaGetLastError``."""
    fn = getattr(library(), fn_name)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {err}")
    LAUNCHES[counter] += 1


def check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous tensors on one "
                             f"CUDA device, got {t.device}, contiguous="
                             f"{t.is_contiguous()}")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def route(t: torch.Tensor) -> str:
    """'cuda' or 'cpu' by the tensor's device; any other device raises."""
    if t.device.type in ("cuda", "cpu"):
        return t.device.type
    raise ValueError(f"no kernel or plain version for device {t.device}")
