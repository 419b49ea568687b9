"""The JAX record that ``chip_smoke.py`` holds the card's run to on every
end-to-end path (``tests/fixtures/jax_record.json`` and its boolean maps,
written by ``scripts/make_jax_record.py`` from the JAX package on a CPU):
its schema and provenance, each path's configuration against the port's
preset, the input hashes against the port's synthetic inputs, and the
port's CPU run of the 640x480 force paths held to it with ``chip_smoke``'s
own gate code (``hold_force_to_jax``), free-running and given JAX's
alignment, with the gates stated there: force within 1%, ECC and
prealignment translations within 0.05 px, equal carrier bins, reliable
masks agreeing on >= 99.5% of the pixels.  No pipeline runs at 2160x3840
here: ``test_torch_jax_record_4k.py`` holds the port's CPU run to the
record on the other paths, under ``VISTAF_RUN_SLOW=1``.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

from vistaf_torch.config import FTPConfig, ForceConfig, TempConfig
from vistaf_torch.pipelines.force import ForcePipeline
from vistaf_torch.utils.synthetic import synthetic_deploy_temp_weights, synthetic_pair

import chip_smoke as smoke
from torch_threads import single_torch_thread  # noqa: F401  (autouse)

RECORD_MB = 2.2
PATHS_640 = ("640", "parity640", "hist640", "prealign640")
KINDS = {"force": ("ref", "def"), "temperature": ("frame",), "multimodal": ("ref", "def"),
         "streams": ("refs",), "limb": ("refs", "defs", "pose", "accel")}


def normal(cfg):
    """A configuration as the record stores it: ``asdict`` through JSON."""
    return json.loads(json.dumps(dataclasses.asdict(cfg)))


@pytest.fixture(scope="module")
def port_configs():
    """Each path's port configurations, as chip_smoke.py drives the path:
    (force preset, temperature preset)."""
    forces = smoke.force_path_configs()
    out = {p: (forces[p][0], None) for p in smoke.JAX_PATHS if p in forces}
    out.update(temp4k=(None, TempConfig().deploy()), temp4k_parity=(None, TempConfig()),
               mm4k=(FTPConfig().deploy(), TempConfig().deploy()),
               mm4k_parity=(FTPConfig(), TempConfig()),
               streams640=(smoke.stream_inputs()[0], None), limb640=(smoke.limb_inputs()[0], None),
               streams640_parity=(forces["parity640"][0], None))
    return out


@pytest.fixture(scope="module")
def record():
    return smoke.jax_record()


def test_record_schema_and_provenance(record):
    paths, bool_map = record
    with open(os.path.join(smoke.RECORD_DIR, "jax_record.json")) as f:
        whole = json.load(f)
    prov = whole["provenance"]
    for key in ("jax", "jaxlib", "numpy", "cpu", "backend", "script", "seconds"):
        assert prov[key], key
    assert prov["backend"] == "cpu" and prov["seed"] == smoke.SEED
    assert prov["script"] == "scripts/make_jax_record.py"
    assert sorted(paths) == sorted(smoke.JAX_PATHS)
    for path, entry in paths.items():
        assert entry["kind"] in KINDS, path
        assert set(KINDS[entry["kind"]]) <= set(entry["inputs"]), path
        assert entry["seconds"] > 0 and entry["result"], path
        for name, shape in entry.get("maps", {}).items():
            m = bool_map(path, name)
            assert m.shape == tuple(shape) and m.any(), (path, name)
    size = sum(os.path.getsize(os.path.join(smoke.RECORD_DIR, f))
               for f in ("jax_record.json", whole["maps"]))
    assert size < RECORD_MB * 2 ** 20, size


def test_every_path_is_driven_with_a_jax_line():
    """Each path of the record is one chip_smoke.py drives and holds to it."""
    cfgs = smoke.force_path_configs()
    for path in smoke.JAX_PATHS:
        assert path in cfgs or path in smoke.PATH_KERNELS, path
    assert set(smoke.JAX_UNDETERMINED) <= set(smoke.JAX_PATHS)
    for names in smoke.JAX_UNDETERMINED.values():
        assert set(names) <= {"free", "ecc", "prealign"}, names


@pytest.mark.parametrize("path", smoke.JAX_PATHS)
def test_configuration_is_the_ports_preset(record, port_configs, path):
    entry = record[0][path]
    force, temp = port_configs[path]
    assert entry["config"] == normal(force if force is not None else temp)
    if entry["kind"] == "multimodal":
        assert entry["temp_config"] == normal(temp)
    if "force_config" in entry:
        assert entry["force_config"] == normal(ForceConfig())
    assert entry["shape"] == ([smoke.H, smoke.W] if "640" in path
                              else [smoke.H4K, smoke.W4K])


def test_input_hashes_match_the_ports_inputs(record):
    """The 640x480 force pairs, one 2160x3840 pair, the stream and limb
    stacks and the temperature models hash to the record's."""
    paths = record[0]
    cfgs = smoke.force_path_configs()
    for path in PATHS_640 + ("4k",):
        cfg, h, w = cfgs[path]
        ref, de = synthetic_pair(h, w, cfg, seed=smoke.SEED)
        assert paths[path]["inputs"] == {"ref": smoke.input_digest(ref),
                                         "def": smoke.input_digest(de)}, path
    _, refs, seq = smoke.stream_inputs()
    smoke.check_jax_inputs("streams640", refs=refs,
                           **{f"batch{t}": b for t, b in enumerate(seq)})
    _, refs, defs, (pose, accel) = smoke.limb_inputs()
    smoke.check_jax_inputs("limb640", refs=refs, defs=defs, pose=pose, accel=accel)
    models = smoke.model_arrays(synthetic_deploy_temp_weights(smoke.SEED))
    for path in ("temp4k", "temp4k_parity", "mm4k", "mm4k_parity"):
        for k, v in models.items():
            assert paths[path]["inputs"][k] == smoke.input_digest(v), (path, k)


def test_changed_input_fails_the_check(record):
    cfg, h, w = smoke.force_path_configs()["640"]
    ref, de = synthetic_pair(h, w, cfg, seed=smoke.SEED)
    de = de.copy()
    de[0, 0, 0] ^= 1
    with pytest.raises(AssertionError, match="input def "):
        smoke.check_jax_inputs("640", **{"ref": ref, "def": de})


@pytest.mark.parametrize("path", PATHS_640)
def test_port_cpu_run_held_to_jax(record, path):
    """The port's CPU run of each 640x480 force path against the record
    through ``chip_smoke.hold_force_to_jax`` (which asserts its gates),
    free-running and given JAX's alignment."""
    cfg, h, w = smoke.force_path_configs()[path]
    ref, de = synthetic_pair(h, w, cfg, seed=smoke.SEED)
    args = (cfg, ForceConfig(), smoke.P2H_MODEL, smoke.FORCE_MODEL)
    pipe = ForcePipeline(*args, debug_outputs=True, device="cpu")
    prealign = smoke.capture_prealign(pipe)
    res = pipe(ref, de)
    line = smoke.hold_force_to_jax(path, args, ref, de, res, "cpu",
                                   prealign[0] if prealign else None)
    assert path not in smoke.JAX_UNDETERMINED
    given = line["given_alignment"]
    assert given["force_gap"] <= smoke.FORCE_RTOL and given["own_ecc_gap_px"] < smoke.ECC_ATOL_PX
    assert line["free"]["carrier_bins_equal"]
    assert bool(prealign) == (line["prealign_warp_jax"] is not None)
    assert np.isfinite(line["free"]["volume_gap"])
