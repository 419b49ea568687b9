"""Hand-written Hopper kernels and their plain PyTorch versions.

One module per kernel, each replacing one Pallas kernel of the JAX
package's ``pallas/``: ``quantile_kernel`` (K1 masked quantiles, K2 the
fused median/MAD), ``inpaint_kernel`` (K3), ``ecc_kernel`` (K4, one ECC
Gauss-Newton iteration's moments), ``ecc_loop_kernel`` (K5, the whole ECC
solve), ``unwrap_kernel`` (K6, the whole WLS-PCG unwrap) and
``polyfit_kernel`` (K7, the whole IRLS fit).  The CUDA sources live in
``vistaf_torch/csrc``; they are compiled by ``nvcc`` into one shared
library with a plain C interface at first use, into ``vistaf_torch/_build``
(keyed on a hash of the sources and flags), and loaded with ``ctypes``.

Every public wrapper dispatches on the device of its input tensor only: a
CUDA tensor launches the kernel (or raises), a CPU tensor runs the plain
version, anything else raises.  Nothing catches a build or launch failure
and carries on.  ``LAUNCHES[name]`` counts the kernel launches of each
wrapper; nothing else touches it.

Routing rule.  At each shape the port takes the route the JAX package
takes on a TPU, which is what the deploy contract was certified on.  Each
kernel module holds a ``fits(shape)`` predicate that copies the JAX
package's VMEM budget (and cites it); the route depends on the shape only,
never on the device, so a CPU run walks the same route as the card.

- Where the JAX package's above-budget route is a different algorithm, the
  port follows it by shape: the ECC takes K5 (whole loop) while
  ``ecc_loop_kernel.fits`` and ``ecc_kernel.fits`` hold and no seed is
  given, else the per-iteration loop with K4 while ``ecc_kernel.fits``
  holds, else the plain moments; the polyfit takes K7 while
  ``polyfit_kernel.fits`` holds, else the IRLS with K2 (whose own
  above-budget route is the bisection pair with the |x - med| range as the
  MAD bracket, two K1 launches); ``unwrap_method='wls_pallas'`` takes K6 while
  ``unwrap_kernel.fits`` holds, else the plain PCG.
- Where the above-budget route is the same computation, the port keeps its
  kernel at every size: K1 (the JAX package's bisection fallback has the
  same levels) and K3 (its XLA diffusion is the same stencil).
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
    "masked_median_mad": 0,
    "inpaint_diffusion": 0,
    "gn_moments_euclidean": 0,
    "ecc_loop_euclidean": 0,
    "unwrap_wls": 0,
    "robust_polyfit2d": 0,
}

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# --fmad=false keeps a*b + c as two roundings, as in the plain versions
# (K6's matrix products call fmaf explicitly)
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xcompiler", "-fPIC")
NVCC_FLAGS = ARCH_FLAGS + ("-Xptxas", "-v")


def pad_up(n: int, m: int) -> int:
    """Smallest multiple of ``m`` that is >= ``n`` (the JAX package's
    ``pallas/common.py::pad_up``)."""
    return -(-n // m) * m


def padded_elems(shape) -> int:
    """Elements of a 2-D f32 plane padded to the TPU's (8, 128) VMEM tile
    (``pallas/common.py::padded_elems``): the unit of every ``fits``
    budget the JAX package routes by."""
    return pad_up(shape[0], 8) * pad_up(shape[1], 128)


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # x, mask, folded, out, batch, n, fractions (host), nq, levels, stream
    "vt_masked_quantiles": (_P, _P, _P, _P, _I, _I, _P, _I, _I, _P),
    # x, mask, folded, out, batch, n, levels, stream
    "vt_masked_median_mad": (_P, _P, _P, _P, _I, _I, _I, _P),
    # img, fill, out, scratch, batch, h, w, iters, stream
    "vt_inpaint_diffusion": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    # h, w -> CTAs of the partial-sum pass
    "vt_gn_moments_blocks": (_I, _I),
    # S, T, SM, coeffs, mid, partials, out, h, w, K, stream
    "vt_gn_moments_euclidean": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # S, T, SM, mid, out, h, w, K, max_iters, eps, stall_patience, stream
    "vt_ecc_loop_euclidean": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P),
    # Hp, Wp -> float elements of the scratch
    "vt_unwrap_work_elems": (_I, _I),
    # psi, m, Dh, DhT, Dw, DwT, inv_denom, mask, out, work, h, w, Hp, Wp,
    # cg_iters, tol2, stream
    "vt_unwrap_wls": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
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
    """Compile ``csrc/*.cu`` into the shared library unless it exists: one
    ``nvcc -c`` per source, all started together, then one link.  Raises on
    any compiler failure; writes the compilers' output (``-Xptxas -v``:
    registers, shared memory and spills per kernel) beside it."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    nvcc = _nvcc()
    jobs = []
    for src in sorted(CSRC_DIR.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        jobs.append((src, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, obj, proc in jobs:
        out, _ = proc.communicate()
        log.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode}):\n{out[-3000:]}")
    objs = [str(obj) for _, obj, _ in jobs]
    tmp = so.with_name(so.name + f".{os.getpid()}.tmp")
    if not failed:
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *objs],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"== link\n{link.stdout}")
        if link.returncode != 0:
            failed.append(f"link ({link.returncode}):\n{link.stdout[-3000:]}")
    so.with_suffix(".log").write_text("".join(log))
    for o in objs:
        Path(o).unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
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
