"""Device time per native-4K force frame of the port's hand-written kernels,
and the kernel launches one frame counts, on one GPU.

    python3 scripts/torch_profile_force4k.py LABEL

Run it from the root of a tree of the repository (it imports that tree's
``vistaf_torch`` and ``chip_smoke``), so that two trees can be compared on
one card, one after the other.  It drives ``ForcePipeline`` under
``FTPConfig().deploy()`` on ``synthetic_pair`` at 2160x3840 (two warm-up
frames), counts one frame's launches with ``vistaf_torch.kernels.LAUNCHES``,
profiles three frames with ``torch.profiler`` and prints one JSON line: the
label, the launch counts and [kernel, device ms per frame, launches per
frame] for each kernel of ``vistaf_torch/csrc`` (each lives in an anonymous
namespace).
"""
import json
import sys

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from vistaf_torch import kernels, use_full_fp32  # noqa: E402
from vistaf_torch.config import FTPConfig, ForceConfig  # noqa: E402
from vistaf_torch.pipelines.force import ForcePipeline  # noqa: E402
from vistaf_torch.utils import cuda_graph  # noqa: E402
from vistaf_torch.utils.synthetic import synthetic_pair  # noqa: E402

use_full_fp32()
cfg = FTPConfig().deploy()
ref, de = synthetic_pair(2160, 3840, cfg, seed=0)
fp = ForcePipeline(cfg, ForceConfig(), cs.P2H_MODEL, cs.FORCE_MODEL, device="cuda")
for _ in range(2):
    fp(ref, de)
torch.cuda.synchronize()
kernels.reset_launches()
fp(ref, de)
torch.cuda.synchronize()
launches = dict(kernels.LAUNCHES)
frames = 3
cuda_graph.note_profiler()          # WHILE graphs that go from here on are kept
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    for _ in range(frames):
        fp(ref, de)
    torch.cuda.synchronize()
ours = [[e.key[:80], e.self_device_time_total / 1e3 / frames, e.count / frames]
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
        and ("(anonymous namespace)::" in e.key and "at::native" not in e.key)]
print(json.dumps({"tree": sys.argv[1], "launches": launches, "ours": ours}), flush=True)
