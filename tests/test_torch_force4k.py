"""Native-4K force: the port and the JAX ForcePipeline on the CPU at
2160x3840 under ``FTPConfig().deploy()`` as shipped, with the deploy
contract's gates (``torch_slice_gates``).  The JAX graph takes minutes to
compile at this size and the run holds several GB, so, like the repo's
other 4K tests, it runs only with ``VISTAF_RUN_SLOW=1``::

    VISTAF_RUN_SLOW=1 JAX_PLATFORMS=cpu python -m pytest tests/test_torch_force4k.py -q

The port's own 4K route (pooled coarse-to-fine ECC with K4, pooled unwrap,
IRLS with K2) is checked at 640x480 scale by ``test_torch_slice_4kroutes.py``
and on the card by ``chip_smoke.py``.
"""
import os

import pytest

from vistaf_tpu.config import FTPConfig

import torch_slice_gates as gates

pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def runs():
    if os.environ.get("VISTAF_RUN_SLOW") != "1":
        pytest.skip("native-4K JAX reference run: set VISTAF_RUN_SLOW=1")
    return gates.run_both(FTPConfig().deploy())


def test_force_within_deploy_contract(runs):
    assert gates.force_gap(*runs[:2]) < 0.01


def test_carrier_bins_equal(runs):
    gates.assert_carrier_bins_equal(*runs[:2])


def test_ecc_warp_within_tolerance(runs):
    assert gates.ecc_gap_px(*runs[:2]) < 0.05


def test_reliable_mask_agrees(runs):
    assert gates.reliable_agreement(*runs[:2]) >= 0.995


def test_cpu_run_launched_nothing(runs):
    assert all(v == 0 for v in runs[2].values()), runs[2]
