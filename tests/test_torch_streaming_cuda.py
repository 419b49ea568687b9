"""The streaming and multimodal paths on the card, at small deploy sizes
(``scaled_ftp_config(240, 320).deploy()``, ``scaled_temp_config(240,
320).deploy()``): ``run_overlapped`` over two streams, with its uploads on a
second CUDA stream from pinned memory, is bit for bit the serialized
``StreamingForce`` calls, and ``step_fused(fetch='scalars')`` makes one
device-to-host copy beyond those its forwards make (their loops' host
checks), of the scalars only.  Marked ``cuda``: they skip where PyTorch
sees no GPU (decided in a fixture).  Run on a GPU machine, from the repo
root, with

    python3 -m pytest tests/test_torch_streaming_cuda.py -q -m cuda --noconftest
"""
import numpy as np
import pytest
import torch

from vistaf_torch import kernels
from vistaf_torch.config import ForceConfig
from vistaf_torch.ftp.pipeline import FTPPipeline
from vistaf_torch.parallel.mesh import BatchedForce
from vistaf_torch.pipelines.force import ForcePipeline
from vistaf_torch.pipelines.multimodal import MultimodalPipeline
from vistaf_torch.pipelines.streaming import StreamingForce, init_state, update
from vistaf_torch.temperature.inference import TemperaturePipeline
from vistaf_torch.utils.synthetic import (scaled_ftp_config, scaled_temp_config,
                                          synthetic_deploy_temp_weights, synthetic_pair,
                                          synthetic_tlc_frame)

pytestmark = pytest.mark.cuda

H, W = 240, 320
P2H = {"type": "hinge_saturating",
       "params": {"a": 2.0826494996246554, "b": 4.20441143052732, "c": -1.767844217125454e-09}}
FORCE = {"type": "growth", "params": {"a": 1.6197727931063521, "b": 9.756634595755994}}


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    from vistaf_torch import use_full_fp32
    use_full_fp32()
    kernels.library()
    return torch.device("cuda", 0)


def test_run_overlapped_two_streams_bit_equal_serialized(dev):
    cfg = scaled_ftp_config(H, W).deploy()
    refs = np.stack([synthetic_pair(H, W, cfg, seed=s)[0] for s in range(2)])
    seq = [np.stack([synthetic_pair(H, W, cfg, seed=s, dent_depth_rad=d)[1]
                     for s, d in ((0, 0.2 * t), (1, 0.8 - 0.2 * t))]) for t in range(5)]
    bf = BatchedForce(FTPPipeline(cfg, P2H, device=dev), FORCE)
    kernels.reset_launches()
    over = StreamingForce(bf, 2, window=3).run_overlapped(refs, seq)
    torch.cuda.synchronize()
    for name in ("masked_quantiles", "inpaint_diffusion", "ecc_loop_euclidean", "unwrap_wls",
                 "robust_polyfit2d"):
        assert kernels.LAUNCHES[name] > 0, name
    sf = StreamingForce(bf, 2, window=3)
    serial = [sf(refs, b) for b in seq]
    state = init_state(2, 3, device="cpu")
    assert len(over) == len(serial) == len(seq)
    for a, b in zip(over, serial):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        state, want = update(state, torch.as_tensor(a["force_raw_N"]))
        for k, v in want.items():
            np.testing.assert_array_equal(a[k], v.numpy(), err_msg=k)


def test_fetch_scalars_makes_one_device_to_host_copy(dev, monkeypatch):
    from chip_smoke import compose_multimodal_frame
    from vistaf_torch.utils.profiling import d2h_copies
    fcfg, tcfg = scaled_ftp_config(H, W).deploy(), scaled_temp_config(H, W).deploy()
    ref_g, de_g = synthetic_pair(H, W, fcfg, seed=0)
    tlc = synthetic_tlc_frame(H, W, tcfg, seed=0)
    color, wide = synthetic_deploy_temp_weights(seed=0)
    mm = MultimodalPipeline(ForcePipeline(fcfg, ForceConfig(), P2H, FORCE, device=dev),
                            TemperaturePipeline(tcfg, color, wide, device=dev))
    ref = mm.ingest(compose_multimodal_frame(ref_g, tlc))
    de = mm.ingest(compose_multimodal_frame(de_g, tlc))
    sc = mm.step_fused(ref, de, fetch="scalars")
    base_n, base_b = d2h_copies(lambda: mm.fused_forward(ref, de, stats_only=True))
    got_n, got_b = d2h_copies(lambda: mm.step_fused(ref, de, fetch="scalars"))
    assert got_n - base_n == 1, (base_n, got_n)
    assert sum(got_b) - sum(base_b) == 8 * len(sc) and max(got_b) <= 8 * len(sc), got_b

    fetched = []
    to_cpu = torch.Tensor.cpu

    def counting_cpu(self, *a, **k):
        fetched.append(tuple(self.shape))
        return to_cpu(self, *a, **k)
    monkeypatch.setattr(torch.Tensor, "cpu", counting_cpu)
    again = mm.step_fused(ref, de, fetch="scalars")
    assert fetched == [(len(sc),)], fetched
    assert again == sc and sc["valid_pixels"] > 0
