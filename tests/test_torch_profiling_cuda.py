"""The recorder's card side (``vistaf_torch/utils/profiling.py``): a
replay's WHILE trips by site against the plain loops' trips counted on the
host, the setter's slots against its total, and each replay's device span
against the kernels the profiler traced for it.  Marked ``cuda``: they skip
where PyTorch sees no GPU (decided in a fixture).  Run on a GPU machine,
from the repo root, with

    python3 -m pytest tests/test_torch_profiling_cuda.py -q -m cuda --noconftest
"""
import json
import statistics

import pytest
import torch

from vistaf_torch import kernels
from vistaf_torch.config import ForceConfig, FTPConfig
from vistaf_torch.ftp.pipeline import FTPPipeline
from vistaf_torch.kernels import ecc_kernel, graph_cond_kernel
from vistaf_torch.ops import components, unwrap
from vistaf_torch.pipelines.force import ForcePipeline
from vistaf_torch.pipelines.multimodal import MultimodalPipeline
from vistaf_torch.temperature.inference import TemperaturePipeline
from vistaf_torch.utils import cuda_graph, profiling
from vistaf_torch.utils.synthetic import (scaled_ftp_config, scaled_temp_config,
                                          synthetic_deploy_temp_weights, synthetic_pair,
                                          synthetic_tlc_frame)

pytestmark = pytest.mark.cuda

P2H = {"type": "hinge_saturating",
       "params": {"a": 2.0826494996246554, "b": 4.20441143052732, "c": -1.767844217125454e-09}}
FORCE = {"type": "growth", "params": {"a": 1.6197727931063521, "b": 9.756634595755994}}
EDGE_US = 50.0      # a replay's device span against its kernels, at each end
SLACK_US = 10.0     # the clock mapping's own error


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    from vistaf_torch import use_full_fp32
    use_full_fp32()
    kernels.library()
    profiling.spans_reset()
    yield torch.device("cuda", 0)
    profiling.spans_reset()


def host_trips(fn):
    """fn() run eagerly with each device loop's trips counted on the host
    by site, and the IF nodes run: ({site: trips}, WHILE nodes, IF nodes)."""
    trips, nodes = {}, [0, 0]

    def counted_while(cond, body, state, *, site):
        def counted(s):
            trips[site] = trips.get(site, 0) + 1
            body(s)
        nodes[0] += 1
        cuda_graph.device_while(cond, counted, state, site=site)

    def counted_if(pred, fn_, out, *, site):
        nodes[1] += 1
        cuda_graph.device_if(pred, fn_, out, site=site)

    saved = ecc_kernel.device_while, unwrap.device_while, components.device_if
    ecc_kernel.device_while = unwrap.device_while = counted_while
    components.device_if = counted_if
    try:
        fn()
    finally:
        ecc_kernel.device_while, unwrap.device_while, components.device_if = saved
    return trips, nodes[0], nodes[1]


def test_replay_trips_by_site_equal_the_plain_loops_4k_parity(dev):
    """The 4K parity force forward (the gather ECC and the PCG as WHILE
    nodes, the seed pick an IF node) on one fixed scene: the replay's
    ``ecc`` and ``pcg`` trips equal the plain loops' trips counted on the
    host, ``entry`` its WHILE nodes, ``seed`` its IF nodes, and every slot
    together the setter's runs in that replay."""
    cfg = FTPConfig()
    pipe = FTPPipeline(cfg, P2H, device=dev)
    assert pipe.graph_route()
    ref, de = (torch.as_tensor(f, device=dev) for f in synthetic_pair(2160, 3840, cfg, seed=3))
    want, whiles, ifs = host_trips(lambda: pipe.forward_eager(ref, de))
    assert want.get("ecc", 0) > 0 and want.get("pcg", 0) > 0, want
    pipe.forward(ref, de)                      # eager, then the capture
    torch.cuda.synchronize()
    profiling.spans_reset()
    graph_cond_kernel.reset_sets(dev)
    with profiling._forced(True):
        pipe.forward(ref, de)
    sets = graph_cond_kernel.sets(dev)
    replays = [s for s in profiling.spans() if s.name == "replay"]
    assert len(replays) == 1 and replays[0].device_ns is not None
    got = replays[0].trips
    assert got["ecc"] == want["ecc"] and got["pcg"] == want["pcg"], (got, want)
    assert got["entry"] == whiles and got["seed"] == ifs and got["fold"] == 0, (got, whiles)
    assert sum(got.values()) == sets, (got, sets)
    profiling.spans_reset()


def _mapped_offset(records, events):
    """The trace clock less the recorder's, microseconds: the median middle
    of each replay's bracket (its record lies inside its ``vistaf.replay``
    range)."""
    mids = [((float(e["ts"]) - s.start_ns / 1e3)
             + (float(e["ts"]) + float(e["dur"]) - s.end_ns / 1e3)) / 2
            for s, e in zip(records, events)]
    return statistics.median(mids)


def test_traced_replays_device_spans_cover_their_kernels(dev, tmp_path):
    """``step_fused`` traced by ``torch.profiler`` (host and card): each
    replay's device span, on the trace's clock, covers the kernels, copies
    and memsets the trace ties to that replay's ``cudaGraphLaunch``: it ends
    within EDGE_US after the last, and the first starts within EDGE_US
    after the later of the span's start and the launch's return.  (The
    span starts when the stream reaches the replay; under the profiler's
    per-node tracing the launch holds the host, and so the graph, for up to
    milliseconds after that.)"""
    from chip_smoke import compose_multimodal_frame
    h, w = 240, 320
    fcfg, tcfg = scaled_ftp_config(h, w).deploy(), scaled_temp_config(h, w).deploy()
    ref_g, de_g = synthetic_pair(h, w, fcfg, seed=0)
    tlc = synthetic_tlc_frame(h, w, tcfg, seed=0)
    color, wide = synthetic_deploy_temp_weights(seed=0)
    mm = MultimodalPipeline(ForcePipeline(fcfg, ForceConfig(), P2H, FORCE, device=dev),
                            TemperaturePipeline(tcfg, color, wide, device=dev))
    ref, de = compose_multimodal_frame(ref_g, tlc), compose_multimodal_frame(de_g, tlc)
    want = mm.step_fused(ref, de, fetch="scalars")          # eager, then the capture
    profiling.spans_reset()
    with profiling.device_trace(str(tmp_path)):
        got = [mm.step_fused(ref, de, fetch="scalars") for _ in range(4)]
    assert all(g == want for g in got)
    records = [s for s in profiling.spans() if s.name == "replay"]
    assert len(records) == 4 and all(s.device_ns is not None for s in records)
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e for e in events if e.get("cat") == "user_annotation"
                    and e.get("name") == "vistaf.replay"), key=lambda e: float(e["ts"]))
    assert len(spans) == 4
    offset = _mapped_offset(records, spans)
    launches = [e for e in events if e.get("cat") == "cuda_runtime"
                and e.get("name") == "cudaGraphLaunch"]
    device = [e for e in events if e.get("ph") == "X"
              and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    for s, e in zip(records, spans):
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        mine = [x for x in launches if a <= float(x["ts"]) <= b]
        corr = {(x.get("args") or {}).get("correlation") for x in mine}
        ks = [(float(k["ts"]), float(k["ts"]) + float(k["dur"])) for k in device
              if (k.get("args") or {}).get("correlation") in corr]
        assert len(corr) == 1 and ks, (corr, len(ks))
        d0, d1 = s.device_ns[0] / 1e3 + offset, s.device_ns[1] / 1e3 + offset
        launched = float(mine[0]["ts"]) + float(mine[0]["dur"])
        first, last = min(k[0] for k in ks) - d0, d1 - max(k[1] for k in ks)
        late = min(k[0] for k in ks) - max(d0, launched)
        assert first >= -SLACK_US and late <= EDGE_US, (first, late, launched - d0)
        assert -SLACK_US <= last <= EDGE_US, last
    profiling.spans_reset()
