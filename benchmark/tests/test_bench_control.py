"""The control on the card: the plain reference one precision below the
configuration's float32 (TF32) fails the comparison, at the test sizes of
``small_root``, on three seeds.  ``cuda``: skips without a card.  The
control at the cells' own sizes is ``python3 benchmark/control.py``."""
import pytest

import control


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["mm4k_parity.scalars", "streams640.step"])
def test_tf32_control_is_not_correct(small_root, card, workload):
    rows = control.readings(workload, [2147483721, 2147483722, 2147483723], calls=100,
                            device=card, bench_root=small_root)
    assert not any(r["correct"] for r in rows), rows


def test_control_on_the_cpu_equals_the_reference(small_root, one_thread):
    """Without TF32 (the CPU has none) the control is the reference itself:
    every number reads 0, so the machinery holds the program's place."""
    import torch
    rows = control.readings("streams640.step", [3], calls=20, device=torch.device("cpu"),
                            bench_root=small_root)
    assert rows[0]["correct"] and all(v["value"] == 0.0 for v in rows[0]["numbers"].values())
