"""The stream batch's and the whole-limb steps' CUDA-graph bodies on the CPU.

On the card ``BatchedForce.batched()`` / ``sharded()``, a ``StreamingForce``
step and each ``whole_limb_step`` / ``whole_limb_step_aux`` step replay one
CUDA graph of ``batched_eager``, ``step_eager`` and the step's ``eager``
(the JAX package's ``jit(vmap(_single))`` and its jitted steps); on the CPU
and on a gloo mesh each runs eagerly.  Here, at 640x480 under
``slice_ftp_config(480, 640)`` (the deploy preset), over two streams with a
world-1 gloo mesh:

- each captured body, after one warm-up, reads nothing on the host
  (``torch_host_guard.no_host_reads``) and gives the unguarded call's bits;
- a ``StreamingForce`` over six batches, and after ``reset()`` with the same
  and with another window, gives bit for bit the outputs and the smoothing
  state of the per-stream loop it replaces: each stream through
  ``BatchedForce._single``, stacked, then ``streaming.update``;
- nothing takes the graph route on the CPU, and the step bodies run there
  what they run on the card: ``batched_eager`` and ``_single_eager``, never
  ``_single`` (the card's graph replay of one stream);
- a WHILE graph's ``ForwardGraph`` hands its graph to ``_release`` when it
  goes, which keeps it only once a profiler has traced the card.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

from vistaf_torch.config import slice_ftp_config
from vistaf_torch.ftp.pipeline import FTPPipeline
from vistaf_torch.parallel import mesh as tmesh
from vistaf_torch.pipelines import streaming
from vistaf_torch.utils.synthetic import synthetic_pair
from torch_host_guard import PLAIN_VERSIONS, no_host_reads, same_tensors
from torch_threads import single_torch_thread  # noqa: F401  (autouse)

H, W, S = 480, 640, 2
WINDOW, ALPHA = 3, 0.2
P2H = {"type": "hinge_saturating", "params": {"a": 2.08, "b": 4.2, "c": 0.0}}
FORCE = {"type": "growth", "params": {"a": 1.62, "b": 9.76}}
DENTS = (0.8, 0.0, 0.5)          # each stream's deformed frames (0: no contact)
BATCHES = 6                      # batch t: stream s's frame (s + t) % 3
CANVAS, STRIDE = (2 * H, 2 * W), 2


@pytest.fixture(scope="module")
def world():
    """The pipeline, the streams' frames, each stream frame's ``_single``
    result (the warm-up of every body below) and a world-1 gloo mesh, which
    goes down with the module."""
    cfg = slice_ftp_config(H, W)
    bf = tmesh.BatchedForce(FTPPipeline(cfg, P2H, device="cpu"), FORCE)
    refs = np.stack([synthetic_pair(H, W, cfg, seed=s)[0] for s in range(S)])
    frames = [[synthetic_pair(H, W, cfg, seed=s, dent_depth_rad=d)[1] for d in DENTS]
              for s in range(S)]
    single = {(s, j): bf._single(refs[s], frames[s][j])
              for s in range(S) for j in range(len(DENTS))}
    assert not dist.is_initialized()
    mesh = tmesh.make_stream_mesh(device="cpu")
    yield dict(bf=bf, refs=refs, frames=frames, single=single, mesh=mesh)
    dist.destroy_process_group()


def _batch(world, t):
    """Batch t: the frames and the (stream, frame) keys of ``single``."""
    keys = [(s, (s + t) % len(DENTS)) for s in range(S)]
    return np.stack([world["frames"][s][j] for s, j in keys]), keys


def _stacked(world, keys, names=None):
    outs = [world["single"][k] for k in keys]
    return {n: torch.stack([o[n] for o in outs]) for n in (names or outs[0])}


def _loop_step(world, state, keys):
    """The per-stream loop a step replaces: the streams' ``_single``
    results stacked, then ``update``."""
    res = _stacked(world, keys, ("force_N", "max_depth_mm"))
    state, out = streaming.update(state, res["force_N"], ALPHA)
    out["force_raw_N"], out["max_depth_mm"] = res["force_N"], res["max_depth_mm"]
    return state, {k: v.numpy() for k, v in out.items()}


def _same_state(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), (a, b)


def test_nothing_takes_the_graph_route_on_the_cpu(world):
    bf, mesh = world["bf"], world["mesh"]
    sf = streaming.StreamingForce(bf, S, window=WINDOW)
    steps = (tmesh.whole_limb_step(bf, mesh, map_stride=STRIDE),
             tmesh.whole_limb_step_aux(bf, mesh, CANVAS, map_stride=STRIDE))
    assert not bf.graph_route() and not sf.graph_route()
    assert not any(step.graph_route() for step in steps)
    assert sf._graph is None and bf._graph is None and all(s.graph is None for s in steps)


@pytest.mark.parametrize("path", ["streaming", "limb"])
def test_step_bodies_run_the_same_on_every_route(world, monkeypatch, path):
    """On the CPU the ``StreamingForce`` step and a whole-limb step take
    their streams through ``_single_eager``, as their graphs do on the
    card: ``_single`` is never called, and each stream gives its bits."""
    bf, mesh = world["bf"], world["mesh"]
    monkeypatch.setattr(bf, "_single", lambda *a: pytest.fail("_single was called"))
    frames, keys = _batch(world, 3)
    want = _stacked(world, keys)
    if path == "streaming":
        sf = streaming.StreamingForce(bf, S, window=WINDOW, ema_alpha=ALPHA)
        got = sf(world["refs"], frames)
        np.testing.assert_array_equal(got["force_raw_N"], want["force_N"].numpy())
        np.testing.assert_array_equal(got["max_depth_mm"], want["max_depth_mm"].numpy())
    else:
        got = tmesh.whole_limb_step(bf, mesh)(world["refs"], frames)
        same_tensors({"per_stream_force": got["per_stream_force"]},
                     {"per_stream_force": want["force_N"]})


def test_batched_eager_reads_nothing_on_the_host(world, monkeypatch):
    """``batched_eager`` (what the batch graph captures) under the guard:
    each stream bit for bit its ``_single``, which ``batched()`` stacks on
    the CPU."""
    bf = world["bf"]
    frames, keys = _batch(world, 0)
    refs, frames = bf.pipe.upload(world["refs"]), bf.pipe.upload(frames)
    with no_host_reads(monkeypatch, PLAIN_VERSIONS):
        got = bf.batched_eager(refs, frames)
    same_tensors(got, _stacked(world, keys))


def test_streaming_step_body_reads_nothing_on_the_host(world, monkeypatch):
    """``StreamingForce.step_eager`` (what a step's graph captures) under
    the guard: the outputs and the new state of the loop step."""
    sf = streaming.StreamingForce(world["bf"], S, window=WINDOW, ema_alpha=ALPHA)
    frames, keys = _batch(world, 1)
    refs, frames = sf._upload(world["refs"]), sf._upload(frames)
    buffers = tuple(sf._state)
    with no_host_reads(monkeypatch, PLAIN_VERSIONS):
        got = sf.step_eager(refs, frames)
    state, want = _loop_step(world, streaming.init_state(S, WINDOW, "cpu"), keys)
    assert all(a is b for a, b in zip(sf._state, buffers))       # rewritten in place
    _same_state(sf._state, state)
    same_tensors(got, {k: torch.as_tensor(v) for k, v in want.items()})


@pytest.mark.parametrize("aux", [False, True], ids=["limb", "limb_aux"])
def test_limb_step_bodies_read_nothing_on_the_host(world, monkeypatch, aux):
    """Each whole-limb step's ``eager`` body (what its graph captures) on the
    gloo mesh under the guard, against the same step called unguarded."""
    bf, mesh = world["bf"], world["mesh"]
    frames, _ = _batch(world, 2)
    if aux:
        step = tmesh.whole_limb_step_aux(bf, mesh, CANVAS, map_stride=STRIDE)
        extra = {"pose_px": np.array([[5, 300], [470, 10]], np.int32),
                 "accel_mss": np.array([[0.0, 11.0, 0.0], [1.0, 0.0, 0.0]], np.float32)}
    else:
        step, extra = tmesh.whole_limb_step(bf, mesh, map_stride=STRIDE), None
    want = step(world["refs"], frames, extra)
    inputs = [tmesh.shard_local_batch(mesh, x) for x in (world["refs"], frames)]
    inputs += [tmesh.shard_local_batch(mesh, extra[k]) for k in step.aux_keys]
    with no_host_reads(monkeypatch, PLAIN_VERSIONS):
        got = step.eager(*inputs)
    same_tensors(got, want)
    assert float(want["total_force_N"]) > 0.0


def test_streaming_steps_and_reset_equal_the_per_stream_loop(world):
    """Six batches, then ``reset()`` (the buffers kept, zeroed) and a batch,
    then ``reset(window=4)`` (new buffers) and a batch: every output and the
    state after each batch bit for bit the loop's."""
    sf = streaming.StreamingForce(world["bf"], S, window=WINDOW, ema_alpha=ALPHA)
    state = streaming.init_state(S, WINDOW, "cpu")
    contact = []
    for t in range(BATCHES):
        frames, keys = _batch(world, t)
        got = sf(world["refs"], frames)
        state, want = _loop_step(world, state, keys)
        assert got.keys() == want.keys()
        for k in want:
            assert np.asarray(got[k]).dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"batch {t} {k}")
        _same_state(sf._state, state)
        contact.append(want["in_contact"])
    assert any(c.any() for c in contact) and not all(c.all() for c in contact)
    assert int(sf._state.count) == BATCHES
    for window in (WINDOW, 4):
        buffers = tuple(sf._state)
        sf.reset(window if window != WINDOW else None)
        kept = all(a is b for a, b in zip(sf._state, buffers))
        assert kept == (window == WINDOW)
        fresh = streaming.init_state(S, window, "cpu")
        _same_state(sf._state, fresh)
        frames, keys = _batch(world, 0)
        got = sf(world["refs"], frames)
        state, want = _loop_step(world, fresh, keys)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"window {window} {k}")
        _same_state(sf._state, state)


@pytest.mark.parametrize("profiled", [False, True])
def test_while_graphs_are_kept_only_after_a_profiler(monkeypatch, profiled):
    """A ``ForwardGraph`` with a WHILE node hands its graph and body pool to
    ``_release`` when it goes: kept for the life of the process once a
    profiler has traced the card in it, else let go."""
    from vistaf_torch.utils import cuda_graph
    monkeypatch.setattr(cuda_graph, "_RETAINED", [])
    monkeypatch.setattr(cuda_graph, "_PROFILED", [False])
    if profiled:
        cuda_graph.note_profiler()
    graph, pool = object(), object()
    cuda_graph._release(graph, pool)
    assert cuda_graph._RETAINED == ([(graph, pool)] if profiled else [])
