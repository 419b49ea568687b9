"""The volume tail of the port's ForcePipeline against the JAX functions on
the CPU: ``host_volume_from_reductions`` bit for bit, and
``depth_map_to_volume_cm3`` with ``mm_per_px`` as a 0-d float32 tensor
(the fused step's and ``BatchedForce``'s form) against the Python float and
the JAX function; the device ``mm_per_px`` with an override.  The config 2
and 3 surfaces and the evidence surface are held to JAX in
``test_torch_multimodal.py``, on the JAX forward compiled there.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vistaf_tpu.config import ForceConfig as JaxForceConfig
from vistaf_tpu.pipelines import force as jax_force
from vistaf_tpu.utils.synthetic import scaled_ftp_config

from vistaf_torch.config import force_config_from_dict, ftp_config_from_dict
from vistaf_torch.pipelines import force as port_force

import torch_slice_gates as gates
from torch_threads import single_torch_thread  # noqa: F401  (autouse)

H, W = 240, 320
EPS = 0.01


@pytest.mark.parametrize("seed", range(4))
def test_host_volume_from_reductions_bit_equal(seed):
    rng = np.random.default_rng(seed)
    s, d = (float(np.float32(v)) for v in rng.uniform(0.0, 50.0, 2))
    n = 0.0 if seed == 0 else float(rng.integers(1, 20000))
    mm = np.float32(rng.uniform(0.05, 0.5))
    assert (port_force.host_volume_from_reductions(s, n, d, mm)
            == jax_force.host_volume_from_reductions(s, n, d, mm))


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_volume_with_device_mm_per_px(sign):
    """A 0-d float32 mm_per_px gives the Python float's bits, the host tail
    over the reductions gives the device tail's, and both agree with the
    JAX function at rel 1e-6 (the sums' order)."""
    rng = np.random.default_rng(3)
    z = (sign * rng.uniform(-0.05, 0.4, size=(64, 80))).astype(np.float32)
    z[rng.random(z.shape) > 0.97] = np.nan
    roi = rng.random(z.shape) > 0.1
    mm = 2.0 / 11.97
    zt, rt = torch.as_tensor(z), torch.as_tensor(roi)
    by_float = port_force.depth_map_to_volume_cm3(zt, rt, mm, EPS)
    by_tensor = port_force.depth_map_to_volume_cm3(
        zt, rt, torch.tensor(mm, dtype=torch.float32), EPS)
    for a, b in zip(by_float, by_tensor):
        assert torch.equal(a, b)
    s, n, d, _ = port_force.depth_map_reductions(zt, rt, EPS)
    host = port_force.host_volume_from_reductions(float(s), float(n), float(d), np.float32(mm))
    assert host == tuple(float(t) for t in by_float)
    ref = jax_force.depth_map_to_volume_cm3(jnp.asarray(z), jnp.asarray(roi),
                                            jnp.float32(mm), EPS)
    for a, b in zip(by_tensor, ref):
        assert float(a) == pytest.approx(float(b), rel=1e-6)


def test_mm_per_px_device_override():
    fcfg = force_config_from_dict(dataclasses.asdict(JaxForceConfig()))
    cfg = ftp_config_from_dict(dataclasses.asdict(scaled_ftp_config(H, W).deploy()))
    pipe = port_force.ForcePipeline(cfg, fcfg, gates.P2H, gates.FORCE, device="cpu")
    over = port_force.ForcePipeline(cfg, dataclasses.replace(fcfg, override_mm_per_px=0.125),
                                    gates.P2H, gates.FORCE, device="cpu")
    got = over.mm_per_px_device(torch.tensor(12.0))
    assert got.dtype == torch.float32 and float(got) == 0.125
    assert float(pipe.mm_per_px_device(torch.tensor(0.0))) == pytest.approx(2.0 / 1e-12)


