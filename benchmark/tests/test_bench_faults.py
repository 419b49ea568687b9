"""A whole run on the CPU at a small size, the look for a card skipped:
sound, it comes out correct; with the timed path broken underneath, once
for each fault the cell can have, it comes out not correct.

The multimodal step has no state and no batch, so its fault is an answer
altered where it is produced (the force, by 1%); the stream cells' are a
step that returns its state unchanged, half of the batch left out (the
rest's mean in its place) and an answer altered (every force by 5%: the
streams' limits allow 1.5% of full scale at the median step, `PERF.md`).
Nothing here crosses chips."""
import io
import json

import pytest
import torch

import run


def _result(root, workload, seed=2147483713, seconds=1.0):
    buf = io.StringIO()
    assert run.run(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                    "--trace", "0"], device=torch.device("cpu"), bench_root=root,
                   out=buf) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _altered_force(factor):
    def fault(monkeypatch):
        from vistaf_torch.calib import scalar_models
        real = scalar_models.predict_force_from_volume

        def altered(model, v, xp=torch):
            return real(model, v, xp=xp) * factor
        monkeypatch.setattr(scalar_models, "predict_force_from_volume", altered)
    return fault


def _state_unchanged(monkeypatch):
    from vistaf_torch.pipelines import streaming
    real = streaming.update

    def stale(state, forces, *a, **k):
        return state, real(state, forces, *a, **k)[1]
    monkeypatch.setattr(streaming, "update", stale)


def _half_batch(monkeypatch):
    from vistaf_torch.parallel.mesh import BatchedForce
    real = BatchedForce.batched_eager

    def half(self, refs, frames):
        n = frames.shape[0] // 2
        out = real(self, refs[:n], frames[:n])
        return {k: torch.cat([v, v.mean(dim=0, keepdim=True).expand(
            frames.shape[0] - n, *v.shape[1:]).to(v.dtype)]) for k, v in out.items()}
    monkeypatch.setattr(BatchedForce, "batched_eager", half)


@pytest.mark.parametrize("workload", ["mm4k_parity.scalars", "streams640.step",
                                      "streams640.ahead"])
def test_sound_run_is_correct(small_root, one_thread, workload):
    res = _result(small_root, workload)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks"
    assert res["metrics"]["frames_per_s"]["value"] > 0


@pytest.mark.parametrize("workload, fault", [
    ("mm4k_parity.scalars", _altered_force(1.01)),
    ("streams640.step", _altered_force(1.05)),
    ("streams640.step", _state_unchanged),
    ("streams640.step", _half_batch),
    ("streams640.ahead", _state_unchanged),
])
def test_fault_is_not_correct(small_root, one_thread, monkeypatch, workload, fault):
    fault(monkeypatch)
    res = _result(small_root, workload)
    assert not res["correct"] and res["failed"] > 0
