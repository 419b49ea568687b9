"""The port's streaming path against the JAX package's on the CPU:
``update`` step by step against the JAX ``update`` on seeded force
sequences (ring wrap, contact hysteresis, window 1), within 1e-6 (the
masked mean's sum order; the ring, the median, the flags and the count are
equal); ``StreamingForce.run_overlapped`` against its serialized calls with
a stand-in batched callable, as ``test_streaming.py`` does, bit for bit,
and against the JAX ``StreamingForce`` with the same stand-in within 1e-6;
``BatchedForce.batched()`` at B = 2 under ``scaled_ftp_config(240,
320).deploy()``, each stream bit for bit the port's ``_single``, and
``StreamingForce`` over it.  ``BatchedForce`` against JAX is in
``test_torch_multimodal.py``, on the JAX forward compiled there.  On the
CPU ``run_overlapped`` runs its batches one after the other; its
two-stream form on the card is ``test_torch_streaming_cuda.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vistaf_tpu.pipelines import streaming as jax_streaming
from vistaf_tpu.utils.synthetic import scaled_ftp_config

from vistaf_torch import kernels
from vistaf_torch.config import ftp_config_from_dict
from vistaf_torch.ftp.pipeline import FTPPipeline
from vistaf_torch.parallel.mesh import BatchedForce
from vistaf_torch.pipelines import streaming
from vistaf_torch.utils.synthetic import synthetic_pair

import torch_slice_gates as gates
from torch_threads import single_torch_thread  # noqa: F401  (autouse)

H, W = 240, 320
OUT_KEYS = ("force_mean_N", "force_median_N", "force_ema_N", "in_contact", "total_force_N")


def _forces(seed, steps, n):
    """Seeded per-stream forces around the 0.1 / 0.3 N hysteresis
    thresholds, with runs of repeats and a zero stream."""
    rng = np.random.default_rng(seed)
    f = rng.uniform(0.0, 0.6, size=(steps, n)).astype(np.float32)
    f[steps // 2:steps // 2 + 2] = f[steps // 2 - 1]
    f[:, -1] = 0.0 if n > 2 else f[:, -1]
    return f


def _assert_state_equal(s, js):
    np.testing.assert_array_equal(s.ring.numpy(), np.asarray(js.ring))
    assert int(s.count) == int(js.count) and s.count.dtype == torch.int32
    np.testing.assert_allclose(s.ema.numpy(), np.asarray(js.ema), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(s.in_contact.numpy(), np.asarray(js.in_contact))


@pytest.mark.parametrize("n,window,steps,alpha", [
    (3, 4, 11, 0.2),     # the ring wraps twice
    (2, 1, 7, 0.2),      # window 1: the median is the last reading
    (4, 8, 19, 0.35),    # BASELINE config 4's window, another alpha
    (5, 3, 3, 0.2),      # never wraps
])
def test_update_matches_jax(n, window, steps, alpha):
    forces = _forces(window * 100 + n, steps, n)
    state = streaming.init_state(n, window, device="cpu")
    jstate = jax_streaming.init_state(n, window)
    jupdate = jax.jit(jax_streaming.update, static_argnums=(2,))
    switched = 0
    for f in forces:
        prev = state.in_contact.clone()
        state, out = streaming.update(state, torch.as_tensor(f), alpha)
        jstate, jout = jupdate(jstate, jnp.asarray(f), alpha)
        _assert_state_equal(state, jstate)
        np.testing.assert_array_equal(out["force_median_N"].numpy(),
                                      np.asarray(jout["force_median_N"]))
        np.testing.assert_array_equal(out["in_contact"].numpy(), np.asarray(jout["in_contact"]))
        for k in ("force_mean_N", "force_ema_N", "total_force_N"):
            np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]), rtol=1e-6,
                                       atol=1e-6, err_msg=k)
        assert all(out[k].dtype == torch.float32 for k in OUT_KEYS if k != "in_contact")
        switched += int((prev != out["in_contact"]).sum())
    assert switched > 0                     # the hysteresis was exercised


def test_update_ema_seeds_from_the_first_forces():
    state = streaming.init_state(2, 4, device="cpu")
    state, out = streaming.update(state, torch.tensor([0.5, 2.0]))
    assert out["force_ema_N"].tolist() == [0.5, 2.0]
    state, out = streaming.update(state, torch.tensor([1.5, 0.0]))
    np.testing.assert_allclose(out["force_ema_N"].numpy(), [0.7, 1.6], rtol=1e-6)
    # median of two readings: the lower one, index (2 - 1) // 2 = 0
    assert out["force_median_N"].tolist() == [0.5, 0.0]


class _FakeBatched:
    """Stand-in for BatchedForce: each stream's force is its frame's mean."""
    device = torch.device("cpu")

    def batched(self):
        def fn(refs, frames):
            f = frames.to(torch.float32).mean(dim=(1, 2, 3))
            return {"force_N": f, "max_depth_mm": f * 0.1}
        return fn


class _JaxFakeBatched:
    def batched(self):
        def fn(refs, frames):
            f = jnp.mean(frames.astype(jnp.float32), axis=(1, 2, 3))
            return {"force_N": f, "max_depth_mm": f * 0.1}
        return fn


def test_run_overlapped_matches_serialized_and_jax():
    S = 3
    rng = np.random.default_rng(0)
    refs = rng.integers(0, 255, size=(S, 8, 8, 3)).astype(np.uint8)
    seq = [rng.integers(0, 255, size=(S, 8, 8, 3)).astype(np.uint8) for _ in range(6)]
    over = streaming.StreamingForce(_FakeBatched(), S, window=4).run_overlapped(refs, seq)
    sf = streaming.StreamingForce(_FakeBatched(), S, window=4)
    serial = [sf(refs, fb) for fb in seq]
    jax_sf = jax_streaming.StreamingForce(_JaxFakeBatched(), S, window=4)
    jax_serial = [jax_sf(refs, fb) for fb in seq]
    assert len(over) == len(serial) == 6
    for a, b, c in zip(over, serial, jax_serial):
        assert set(a) == set(b) == set(c)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
            np.testing.assert_allclose(a[k], c[k], rtol=1e-6, atol=1e-6, err_msg=k)
    sf.reset()
    assert int(sf._state.count) == 0 and sf._state.ring.shape == (S, 4)
    sf.reset(window=2)
    assert sf._state.ring.shape == (S, 2)


def test_run_overlapped_empty_sequence_and_mesh():
    sf = streaming.StreamingForce(_FakeBatched(), 2, window=4)
    assert sf.run_overlapped(np.zeros((2, 4, 4, 3), np.uint8), []) == []
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        streaming.StreamingForce(_FakeBatched(), 2, mesh=object())


@pytest.fixture(scope="module")
def batched():
    cfg = ftp_config_from_dict(dataclasses.asdict(scaled_ftp_config(H, W).deploy()))
    pairs = [synthetic_pair(H, W, cfg, dent_depth_rad=d, seed=s)
             for s, d in ((0, 0.8), (1, 0.5))]
    refs = np.stack([p[0] for p in pairs])
    frames = np.stack([p[1] for p in pairs])
    bf = BatchedForce(FTPPipeline(cfg, gates.P2H, device="cpu"), gates.FORCE)
    kernels.reset_launches()
    out = bf.batched()(refs, frames)
    assert all(v == 0 for v in kernels.LAUNCHES.values()), kernels.LAUNCHES
    return dict(out=out, bf=bf, refs=refs, frames=frames)


def test_batched_streams_bit_equal_single(batched):
    bf, out = batched["bf"], batched["out"]
    for b in range(2):
        one = bf._single(batched["refs"][b], batched["frames"][b])
        for k, v in one.items():
            assert torch.equal(out[k][b], v) or (
                k == "height_map_mm" and torch.equal(out[k][b].isnan(), v.isnan())
                and torch.equal(out[k][b].nan_to_num(), v.nan_to_num())), k
    with pytest.raises(ValueError, match="stacks"):
        bf.batched()(batched["refs"], batched["frames"][:1])


def test_streaming_force_on_batched_force(batched):
    """Three batches of the two streams through StreamingForce: overlapped
    equals serialized, and the smoothed readings are ``update`` fed the raw
    forces."""
    bf, refs, frames = batched["bf"], batched["refs"], batched["frames"]
    seq = [frames, frames[::-1].copy(), frames]
    over = streaming.StreamingForce(bf, 2, window=2).run_overlapped(refs, seq)
    sf = streaming.StreamingForce(bf, 2, window=2)
    serial = [sf(refs, fb) for fb in seq]
    state = streaming.init_state(2, 2, device="cpu")
    for a, b in zip(over, serial):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
        state, ref_out = streaming.update(state, torch.as_tensor(a["force_raw_N"]))
        for k in OUT_KEYS:
            np.testing.assert_array_equal(a[k], ref_out[k].numpy())
    np.testing.assert_array_equal(over[0]["force_raw_N"], batched["out"]["force_N"].numpy())
    np.testing.assert_array_equal(over[2]["force_raw_N"], over[0]["force_raw_N"])
