"""The port's span-and-counter recorder (``vistaf_torch/utils/profiling.py``)
on the CPU: off unless a ``torch.profiler`` trace collects (nothing
recorded, no ``record_function`` entered), and under one the span trees of
``MultimodalPipeline.step_fused``, ``StreamingForce.__call__`` and
``StreamingForce.run_overlapped`` (names, parents, one call id a call,
children inside their parents), the same spans as ``vistaf.*`` ranges of
the Chrome trace, a bounded buffer; the sites of ``device_while`` and
``device_if``; ``profile_window``'s busy time as a union of intervals.
The replays' device spans and trips need a card:
``test_torch_profiling_cuda.py``."""
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vistaf_torch.config import ForceConfig, slice_ftp_config
from vistaf_torch.ftp.pipeline import FTPPipeline
from vistaf_torch.parallel.mesh import BatchedForce
from vistaf_torch.pipelines.force import ForcePipeline
from vistaf_torch.pipelines.multimodal import MultimodalPipeline
from vistaf_torch.pipelines.streaming import StreamingForce
from vistaf_torch.temperature.inference import TemperaturePipeline
from vistaf_torch.utils import cuda_graph, profiling
from vistaf_torch.utils.synthetic import (scaled_ftp_config, scaled_temp_config,
                                          synthetic_deploy_temp_weights, synthetic_pair,
                                          synthetic_tlc_frame)

import torch_slice_gates as gates
from torch_threads import single_torch_thread  # noqa: F401  (autouse)

H, W = 144, 192


@pytest.fixture(autouse=True)
def empty_recorder():
    profiling.spans_reset()
    yield
    profiling.spans_reset()


@pytest.fixture(scope="module")
def mm():
    fcfg, tcfg = scaled_ftp_config(H, W).deploy(), scaled_temp_config(H, W).deploy()
    ref, de = synthetic_pair(H, W, fcfg, seed=0)
    tlc = synthetic_tlc_frame(H, W, tcfg, seed=0)
    color, wide = synthetic_deploy_temp_weights(seed=0)
    pipe = MultimodalPipeline(
        ForcePipeline(fcfg, ForceConfig(), gates.P2H, gates.FORCE, device="cpu"),
        TemperaturePipeline(tcfg, color, wide, device="cpu"))
    return pipe, gates.compose_multimodal_frame(ref, tlc), gates.compose_multimodal_frame(de, tlc)


@pytest.fixture(scope="module")
def streams():
    cfg = slice_ftp_config(H, W)
    pairs = [synthetic_pair(H, W, cfg, seed=s, dent_depth_rad=d)
             for s, d in ((0, 0.8), (1, 0.3))]
    refs = np.stack([p[0] for p in pairs])
    batches = [np.stack([p[1] for p in pairs])] * 3
    return BatchedForce(FTPPipeline(cfg, gates.P2H, device="cpu"), gates.FORCE), refs, batches


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, profiling.spans()


def _tree(records):
    """[(name, parent's name), ...] in the order the spans opened."""
    return [(s.name, records[s.parent].name if s.parent >= 0 else None) for s in records]


def _check_nesting(records):
    """One call id a call (its outermost span's), each child inside its
    parent and every span closed."""
    for s in records:
        assert s.end_ns >= s.start_ns > 0
        if s.parent >= 0:
            p = records[s.parent]
            assert s.call == p.call and p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    roots = [s.call for s in records if s.parent < 0]
    assert len(set(roots)) == len(roots)


def test_recorder_is_off_outside_a_trace(mm, streams, monkeypatch):
    """No trace: ``span`` is the shared null context, the entries record
    nothing and enter no ``record_function`` (made to raise here)."""
    assert profiling.span("a") is profiling.span("b")
    assert profiling.on_device(None, torch.device("cpu")) is profiling.span("c")

    def refuse(*a, **k):
        raise AssertionError("record_function entered with the recorder off")
    monkeypatch.setattr(profiling._autograd_profiler, "record_function", refuse)
    pipe, ref, de = mm
    bf, refs, batches = streams
    pipe.step_fused(ref, de, fetch="scalars")
    sf = StreamingForce(bf, 2, window=3)
    sf(refs, batches[0])
    sf.run_overlapped(refs, batches)
    assert profiling.spans() == []
    # forced on, it records without a trace
    monkeypatch.undo()
    with profiling._forced(True):
        with profiling.span("a") as sp:
            pass
    assert sp is not None and [s.name for s in profiling.spans()] == ["a"]


def test_step_fused_span_tree(mm):
    pipe, ref, de = mm
    out, records = _traced(lambda: [pipe.step_fused(ref, de, fetch=f)
                                    for f in ("scalars", "maps")])
    assert _tree(records) == [("step_fused", None), ("ingest", "step_fused"),
                              ("ingest", "step_fused"), ("eager", "step_fused"),
                              ("fetch", "step_fused")] * 2
    _check_nesting(records)
    assert all(s.device_ns is None and s.trips is None for s in records)
    assert out[0] == pipe.step_fused(ref, de, fetch="scalars")


def test_stream_step_and_run_overlapped_span_trees(streams):
    bf, refs, batches = streams
    sf = StreamingForce(bf, 2, window=3)
    _, records = _traced(lambda: sf(refs, batches[0]))
    assert _tree(records) == [("stream_step", None), ("upload", "stream_step"),
                              ("eager", "stream_step"), ("fetch", "stream_step")]
    _check_nesting(records)
    profiling.spans_reset()
    sf.reset()
    outs, records = _traced(lambda: sf.run_overlapped(refs, batches))
    assert _tree(records) == [("run_overlapped", None), ("upload", "run_overlapped"),
                              *[("stage", "run_overlapped"), ("eager", "run_overlapped")] * 3,
                              ("fetch", "run_overlapped")]
    _check_nesting(records)
    assert len(outs) == 3


def test_chrome_trace_holds_the_spans(mm, tmp_path):
    pipe, ref, de = mm
    with profiling.device_trace(str(tmp_path)):
        pipe.step_fused(ref, de, fetch="scalars")
    records = profiling.spans()
    with open(tmp_path / "trace.json") as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "user_annotation" and e["name"].startswith("vistaf.")]
    events.sort(key=lambda e: (float(e["ts"]), -float(e["dur"])))
    assert [e["name"] for e in events] == ["vistaf." + s.name for s in records]
    # each record is read inside its range
    for e, s in zip(events, records):
        assert (s.end_ns - s.start_ns) / 1e3 <= float(e["dur"]) + 1.0


def test_buffer_is_bounded(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    with profiling._forced(True):
        for k in range(5):
            with profiling.span(f"s{k}") as sp:
                pass
    assert sp is None and [s.name for s in profiling.spans()] == ["s0", "s1", "s2"]
    assert profiling._REC.dropped == 2


def test_device_loops_name_their_site():
    """``site`` names one of the setter's slots; ``entry`` is the WHILE
    nodes' first sets and no call site's.  The plain forms run as before."""
    state = (torch.zeros((), dtype=torch.int32),)
    cuda_graph.device_while(lambda s: s[0] < 3, lambda s: s[0].add_(1), state, site="pcg")
    assert int(state[0]) == 3
    out = torch.zeros(2)
    cuda_graph.device_if(torch.tensor(True), lambda t: t.add_(1.0), out, site="seed")
    assert out.tolist() == [1.0, 1.0]
    for bad in ("entry", "ecc_loop"):
        with pytest.raises(ValueError, match="site"):
            cuda_graph.device_while(lambda s: s[0] < 3, lambda s: s[0].add_(1), state,
                                    site=bad)
        with pytest.raises(ValueError, match="site"):
            cuda_graph.device_if(torch.tensor(True), lambda t: t.add_(1.0), out, site=bad)


def test_busy_time_is_the_union_of_device_intervals():
    """``profile_window``'s busy time: a copy under a kernel on another
    stream counts once; host events and instant events do not count."""
    ev = [{"ph": "X", "cat": "kernel", "ts": 0, "dur": 10},
          {"ph": "X", "cat": "gpu_memcpy", "ts": 5, "dur": 10},
          {"ph": "X", "cat": "gpu_memset", "ts": 30, "dur": 2},
          {"ph": "X", "cat": "cpu_op", "ts": 40, "dur": 50},
          {"ph": "i", "cat": "kernel", "ts": 50}]
    assert profiling._device_busy_us(ev) == 17.0
