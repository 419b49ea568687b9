"""The CPU guard of the captured forwards: every way of reading a tensor on
the host made to raise, and the plain versions of the kernels exempt.

A CUDA graph can capture neither a read of the device on the host nor a
copy from the host.  ``no_host_reads`` makes ``Tensor.__bool__``, ``item``,
``tolist``, ``cpu``, ``numpy``, ``__float__``, ``__int__``, ``__index__``,
an index by a 0-dim tensor, whose value PyTorch takes on the host, or by a
boolean mask, and ``nonzero`` and the other ops whose output size the host
must read raise, and ``torch.tensor``, ``torch.as_tensor`` and
``torch.from_numpy`` of host values too, and a Python number written to
one element, which PyTorch copies from a host tensor.  Exempt
(``PLAIN_VERSIONS``): the one host read of ``device_while``'s and
``device_if``'s plain forms (the condition setter's plain version,
``set_conditional_plain``; under a capture a conditional node reads its
condition on the card), and the plain versions of the kernels: K1, K3, K4,
K5, K6, K7 and K8, the labelling kernel and the reconstruction loop that
the labels replace on the card; on the card each is one launch of a kernel
that reads nothing on the host.
"""
import contextlib
import functools

import torch

from vistaf_torch.kernels import (ccl_kernel, ecc_kernel, ecc_loop_kernel, graph_cond_kernel,
                                  inpaint_kernel, polyfit_kernel, quantile_kernel,
                                  temp_kernel, unwrap_kernel)
from vistaf_torch.ops import morphology


class HostRead(AssertionError):
    pass


@contextlib.contextmanager
def no_host_reads(monkeypatch, exempt):
    """Make reading a tensor on the host, and building one from host values,
    raise unless an ``exempt`` function is on the stack."""
    depth = [0]

    def guarded(name, real):
        @functools.wraps(real)
        def f(*a, **k):
            if depth[0] == 0:
                raise HostRead(f"{name} inside the forward")
            return real(*a, **k)
        return f

    def building(name, real):
        @functools.wraps(real)
        def f(data, *a, **k):
            if depth[0] == 0 and not isinstance(data, torch.Tensor):
                raise HostRead(f"torch.{name} of host values inside the forward")
            return real(data, *a, **k)
        return f

    def indexing(name, real):
        """An index that reads the device: a 0-dim tensor (PyTorch takes its
        value on the host) or a boolean mask (its nonzero count); and a
        Python number written to one element (``x[0, 0] = 0.0``), which
        PyTorch copies from a host tensor."""
        @functools.wraps(real)
        def f(self, index, *a):
            parts = index if isinstance(index, tuple) else (index,)
            if depth[0] == 0 and any(isinstance(p, torch.Tensor) and (
                    p.dim() == 0 or p.dtype == torch.bool) for p in parts):
                raise HostRead(f"Tensor.{name} with a 0-dim or boolean tensor index "
                               "inside the forward")
            if depth[0] == 0 and a and not isinstance(a[0], torch.Tensor) and all(
                    isinstance(p, int) for p in parts) and len(parts) == self.dim():
                raise HostRead(f"Tensor.{name} of a host number into one element "
                               "inside the forward")
            return real(self, index, *a)
        return f

    def exempted(real):
        @functools.wraps(real)
        def f(*a, **k):
            depth[0] += 1
            try:
                return real(*a, **k)
            finally:
                depth[0] -= 1
        return f

    for module, name in exempt:
        monkeypatch.setattr(module, name, exempted(getattr(module, name)))
    for name in ("__bool__", "item", "tolist", "cpu", "numpy", "__float__", "__int__",
                 "__index__"):
        monkeypatch.setattr(torch.Tensor, name, guarded(name, getattr(torch.Tensor, name)))
    for name in ("tensor", "as_tensor", "from_numpy"):
        monkeypatch.setattr(torch, name, building(name, getattr(torch, name)))
    for name in ("nonzero", "argwhere", "masked_select", "unique", "repeat_interleave"):
        monkeypatch.setattr(torch, name, guarded(f"torch.{name}", getattr(torch, name)))
    for name in ("nonzero", "masked_select", "unique", "repeat_interleave"):
        monkeypatch.setattr(torch.Tensor, name, guarded(name, getattr(torch.Tensor, name)))
    for name in ("__getitem__", "__setitem__"):
        monkeypatch.setattr(torch.Tensor, name, indexing(name, getattr(torch.Tensor, name)))
    try:
        yield
    finally:
        monkeypatch.undo()


PLAIN_VERSIONS = (
    (graph_cond_kernel, "set_conditional_plain"),          # device_while, device_if
    (quantile_kernel, "masked_quantiles_plain"),           # K1
    (inpaint_kernel, "inpaint_diffusion_plain"),           # K3
    (ecc_kernel, "gn_loop_euclidean_plain"),               # K4 (the prealignment's ECC)
    (ecc_loop_kernel, "ecc_loop_euclidean_plain"),         # K5
    (unwrap_kernel, "unwrap_wls_plain"),                   # K6
    (polyfit_kernel, "robust_polyfit2d_coef_plain"),       # K7
    (temp_kernel, "fused_temperature_maps_plain"),        # K8
    (ccl_kernel, "label_components_plain"),                # the labels
    (morphology, "reconstruct_plain"),                     # the labels' reconstruction
)


def same_tensors(got, want) -> None:
    """Two dicts of tensors equal bit for bit: the same keys, and in each
    tensor the same NaN pixels and the same values elsewhere."""
    assert got.keys() == want.keys(), (sorted(got), sorted(want))
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]) or (
            got[k].is_floating_point() and torch.equal(torch.isnan(got[k]),
                                                       torch.isnan(want[k]))
            and torch.equal(torch.nan_to_num(got[k]), torch.nan_to_num(want[k]))), k
