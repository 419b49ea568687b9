"""K4 (the ECC Gauss-Newton loop, ``csrc/ecc_gn_loop.cu``) alone on one
GPU: each of ``chip_smoke.py``'s ``gn_moments_euclidean`` cases (the
295x295 coarse grid's loop unseeded and seeded, one iteration's matrix and,
where the tree has them, the stacks of solves) through its wrapper.

    python3 scripts/torch_k4_times.py [--label NAME] [--reps N]

Run it from the root of a tree of the repository: it imports that tree's
``vistaf_torch`` and ``chip_smoke``, so that two trees are compared by
running it from the root of each in one call to the card.  For each case it
prints one JSON line: ``shape``, ``iters``, ``launches`` (of the kernel, one
call), ``ms`` (``profiling.cuda_ms``: the median of ``--reps`` calls
between two CUDA events, the host's enqueue included), ``device_ms``
(``profiling.device_ms``: kernel time per call from ``torch.profiler``) and
``max_abs_err`` against the plain version (the case's own check, which for
a stack also holds it bit for bit to each solve's own launch); then the
card's name and power limit.
"""
import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
from vistaf_torch import kernels, use_full_fp32  # noqa: E402
from vistaf_torch.utils.profiling import cuda_ms, device_ms  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default=os.path.basename(os.getcwd()))
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k4_times: CUDA is not available", file=sys.stderr)
        return 1
    use_full_fp32()
    kernels.build()
    device = torch.device("cuda")
    for name, _, _, kern, plain, a, check in cs.kernel_cases(device):
        if name != "gn_moments_euclidean":
            continue
        got = kern(*a)
        err = check(got, plain(*a))
        kernels.reset_launches()
        kern(*a)
        torch.cuda.synchronize()
        launches = kernels.LAUNCHES[name]
        iters = got[2].tolist() if isinstance(got, tuple) else None
        print(json.dumps({"label": args.label, "shape": list(a[0].shape), "iters": iters,
                          "seeded": isinstance(got, tuple) and bool(a[3].abs().sum() > 0),
                          "launches": launches,
                          "ms": cuda_ms(lambda: kern(*a), reps=args.reps, warmup=5),
                          "device_ms": device_ms(lambda: kern(*a), reps=args.reps),
                          "max_abs_err": err}), flush=True)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
