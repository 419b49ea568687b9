"""The metric arithmetic: the rate over the window, the 95th percentile of
all calls, the idle share from overlapping device intervals, the host's
busy time, the rooflines' counts."""
import numpy as np
import pytest

from harness import devtrace
from harness.roofline import bound_ms, least_ms, work
from harness.window import Call, Window, frames_per_s, latency_percentile_ms, spread, \
    tail_percentile


def test_rate_is_frames_over_the_whole_window():
    win = Window([Call(1.0, 1.5, 4, 0, None), Call(1.5, 2.0, 4, 0, None),
                  Call(2.0, 3.0, 4, 0, None)], start=0.9, end=3.0)
    assert frames_per_s(win) == pytest.approx(12 / 2.1)


def test_p95_is_of_every_call_not_of_chunk_medians():
    lat = [10.0] * 95 + [100.0] * 5
    calls, t = [], 0.0
    for ms in lat:
        calls.append(Call(t, t + ms / 1e3, 1, 0, None))
        t += ms / 1e3
    win = Window(calls, 0.0, t)
    assert latency_percentile_ms(win, 95) == pytest.approx(np.percentile(lat, 95))
    assert latency_percentile_ms(win, 95) > 10.0
    # a step of 4 frames: each frame has its step's latency
    win4 = Window([Call(0, 0.01, 4, 0, None), Call(0, 0.02, 1, 0, None)], 0, 0.03)
    assert latency_percentile_ms(win4, 50) == pytest.approx(10.0)


def test_tail_rule_and_spread():
    assert tail_percentile(100) == 90 and tail_percentile(50) == 80
    assert tail_percentile(10) is None
    assert spread([1.0, 2.0, 3.0, 4.0, 5.0]) == pytest.approx((4.5 - 1.5) / 3.0)


def _ev(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


def _trace():
    return devtrace.from_events([
        _ev("user_annotation", "bench.window", 0, 100),
        _ev("user_annotation", "bench.call", 10, 40),
        _ev("user_annotation", "bench.call", 60, 30),
        _ev("kernel", "k1", 10, 20),
        _ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 15, 10, correlation=1),
        _ev("kernel", "k2", 25, 10),            # overlaps k1: counted once
        _ev("kernel", "k3", 60, 10),
        _ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 80, 5, correlation=7),
        _ev("kernel", "outside", 200, 10),
        _ev("cuda_runtime", "cudaGraphLaunch", 11, 2),
        _ev("cuda_runtime", "cudaStreamSynchronize", 30, 15),
        _ev("cuda_runtime", "cudaMemcpyAsync", 70, 16, correlation=7),
        _ev("cuda_runtime", "cudaMemcpyAsync", 12, 3, correlation=1),
    ])


def test_idle_share_is_the_union_of_overlapping_intervals():
    tr = _trace()
    assert tr.window_us == 100
    assert devtrace.busy_us(tr) == pytest.approx(25 + 10 + 5)
    assert devtrace.gaps(tr) == [(0, 10), (35, 60), (70, 80), (85, 100)]
    assert devtrace.union([(0, 5), (3, 8), (10, 12)]) == [(0, 8), (10, 12)]


def test_host_busy_leaves_out_the_waits():
    tr = _trace()
    # waits: the sync (30-45) and the copy whose device side is DtoH (70-86)
    assert sorted(devtrace.waits(tr)) == [(30, 45), (70, 86)]
    calls = devtrace.spans(tr, "bench.call")
    busy = sum((b - a) - devtrace.covered_us((a, b), devtrace.waits(tr))
               for a, b in map(devtrace.interval, calls))
    assert busy == pytest.approx((40 - 15) + (30 - 16))
    assert devtrace.named_at(tr, 40) == "call/cudaStreamSynchronize"
    name, sec = devtrace.top_device_ops(tr)[0]
    assert name == "k1" and sec == pytest.approx(20e-6)


@pytest.mark.parametrize("kernel, case, want_ms, by", [
    ("inpaint_diffusion", {"shape": [2, 1182, 1182], "iters": 20}, 0.0201, "operations"),
    ("inpaint_diffusion", {"shape": [236, 236], "iters": 20}, 0.0004, "operations"),
    ("unwrap_wls", {"shape": [236, 236], "iters": 16}, 0.0316, "operations"),
    ("unwrap_wls", {"shape": [448, 384], "iters": 16}, 0.1470, "operations"),
    ("inpaint_diffusion", {"shape": [2160, 3840], "iters": 96}, 0.2855, "operations"),
])
def test_roofline_counts_reproduce_the_kernel_table(kernel, case, want_ms, by):
    ms, what = bound_ms(*work(kernel, case))
    assert ms == pytest.approx(want_ms, abs=5e-5) and what == by


def test_stack_counts_add_up():
    one = least_ms("unwrap_wls", [{"shape": [236, 236], "iters": 16}])
    four = least_ms("unwrap_wls", [{"shape": [4, 236, 236], "iters": 16}])
    assert four == pytest.approx(4 * one, rel=0.01)
