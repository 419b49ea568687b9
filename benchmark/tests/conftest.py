"""The benchmark's own tests: ``python3 -m pytest benchmark/tests -q`` from
the checkout's root (the tests that need a card are marked ``cuda`` and
skip without one; on the card: ``python3 -m pytest benchmark/tests -q -m
cuda``)."""
import json
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for _p in (ROOT, BENCH / "reference", BENCH):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    """The card, or a skip: decided here, never at import."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (TF32 and the hand-written kernels exist only there)")
    return torch.device("cuda", 0)


@pytest.fixture(scope="session")
def one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="session")
def small_root(tmp_path_factory):
    """A checkout root whose ``BENCHMARK.json`` is the real one and whose
    configuration files are the real ones at sizes a CPU test holds: the
    parity multimodal step at 240x320, the streams at 144x192."""
    import dataclasses
    from plainref.config import slice_ftp_config
    from plainref.utils.synthetic import scaled_ftp_config, scaled_temp_config
    root = tmp_path_factory.mktemp("bench_root")
    (root / "benchmark" / "configs").mkdir(parents=True)
    sp = json.loads((ROOT / "BENCHMARK.json").read_text())

    def d(c):
        return json.loads(json.dumps(dataclasses.asdict(c)))
    mm = json.loads((BENCH / "configs" / "mm4k_parity.json").read_text())
    st = json.loads((BENCH / "configs" / "streams640.json").read_text())
    mm.update(frame=[240, 320], ftp=d(scaled_ftp_config(240, 320)),
              temp=d(scaled_temp_config(240, 320)))
    st.update(frame=[144, 192], ftp=d(slice_ftp_config(144, 192)))
    (root / "benchmark" / "configs" / "mm4k_parity.json").write_text(json.dumps(mm))
    (root / "benchmark" / "configs" / "streams640.json").write_text(json.dumps(st))
    (root / "BENCHMARK.json").write_text(json.dumps(sp))
    return root
