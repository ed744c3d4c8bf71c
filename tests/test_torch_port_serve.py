"""The port's streaming server, ``handnet_tpu_torch.apps.serve.PipelineServer``,
against its own direct forward and against the JAX package's
``handnet_tpu.apps.serve.PipelineServer``.

The counterparts of ``tests/test_serve.py``, at its sizes (a 64x96 detector
on 60x80 frames, so ``preprocess`` resamples; 48^2 crops; batch 4; float32)
and on the CPU, where the server runs its forward eagerly (the CUDA graph
per bucket exists on the card only; ``chip_smoke.py`` holds the replays
against the eager forward there). The server's own results are compared
exactly: a frame's outputs do not depend on the other frames of its batch.

No CPU counterpart here: ``test_sustained_throughput_vs_direct_loop`` (a
timing on the CPU says nothing of the card: ``chip_smoke.py`` prints the
server's ``sustained_fps``, ``compute_fps_probe()`` and ``latency_stats()``
there); the mesh server is held against the one-device server and JAX's
mesh server in tests/test_torch_port_parallel.py.
"""

import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handnet_tpu import config as jconfig
from handnet_tpu.apps.serve import PipelineServer as JaxServer
from handnet_tpu.convert.torch_weights import convert_a2j, convert_fcos
from handnet_tpu_torch import config as pconfig
from handnet_tpu_torch.apps.serve import PipelineServer
from handnet_tpu_torch.graphs import BucketGraphs, dequantize_wire
from handnet_tpu_torch.models.pipeline import HandNetPipeline
from handnet_tpu_torch.nn.quant import save_calibration
from torch_port_fixtures import assert_close


def _cfg(module, **fcos):
    return module.HandNetConfig(
        a2j=module.A2JConfig(crop_h=48, crop_w=48),
        fcos=module.FCOSConfig(image_h=64, image_w=96, max_detections=8, num_classes=2,
                               ext=False, **fcos),
        pipeline=module.PipelineConfig(crop_size=48))


CFG = _cfg(pconfig)
HW = (60, 80)


def _server(cfg=CFG, **kw):
    return PipelineServer(cfg, frame_hw=HW, dtype=torch.float32, device="cpu",
                          **{"batch_size": 4, **kw})


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tests run small forwards; one intra-op thread keeps them from
    crowding the other test processes, some of which time their own runs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def server():
    s = _server().start()
    yield s
    s.stop()


def _frame(seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=HW + (3,)).astype(np.float32),
            rng.uniform(0.3, 1.0, size=HW).astype(np.float32))


def _wire(frame):
    rgb, dep = frame
    return (np.clip(rgb * 255.0, 0, 255).astype(np.uint8),
            np.clip(dep * 1000.0, 0, 65535).astype(np.uint16))


def _static(cfg):
    return dataclasses.replace(cfg, fcos=dataclasses.replace(cfg.fcos, quant="static"),
                               a2j=dataclasses.replace(cfg.a2j, quant="static"))


def test_all_frames_served_with_ids(server):
    n_per_stream = 6
    for sid in range(3):
        for fid in range(n_per_stream):
            server.submit(sid, fid, *_frame(sid * 100 + fid))
    got = {}
    for _ in range(3 * n_per_stream):
        sid, fid, out = server.get(timeout=60)
        assert (sid, fid) not in got
        got[(sid, fid)] = out
    assert set(got) == {(s, f) for s in range(3) for f in range(n_per_stream)}
    sample = got[(0, 0)]
    assert sorted(sample) == ["boxes", "found", "joints_uvd", "scores"]
    assert sample["joints_uvd"].shape == (21, 3)
    assert sample["boxes"].shape == (4,)
    assert np.isfinite(sample["joints_uvd"]).all()


def test_results_match_direct_forward(server):
    """A served frame == the direct forward of a batch of that frame, in the
    wire format the server quantizes to: padding never leaks into a real
    slot."""
    rgb, dep = _frame(7)
    rgb_q, dep_q = _wire((rgb, dep))
    direct = server._fwd(torch.from_numpy(np.broadcast_to(rgb_q, (4,) + rgb.shape).copy()),
                         torch.from_numpy(np.broadcast_to(dep_q, (4,) + dep.shape).copy()))
    server.submit("x", 0, rgb, dep)
    _, _, out = server.get(timeout=60)
    for key in server.out_fields:
        assert np.array_equal(out[key], direct[key][0].numpy()), key


def test_wire_quantization_accepts_sensor_native_frames(server):
    """uint8 RGB and uint16-mm depth pass straight through and give what the
    float frames give once quantized on submit."""
    rgb, dep = _frame(11)
    server.submit("f", 0, rgb, dep)
    server.submit("q", 0, *_wire((rgb, dep)))
    got = {}
    for _ in range(2):
        sid, _, out = server.get(timeout=60)
        got[sid] = out
    assert np.array_equal(got["f"]["joints_uvd"], got["q"]["joints_uvd"])


def test_rejects_wrong_shape(server):
    with pytest.raises(ValueError):
        server.submit(0, 0, np.zeros((32, 32, 3), np.float32), np.zeros((32, 32), np.float32))


def test_dequantize_wire():
    """uint8 RGB / 255 and uint16 mm / 1000 as the JAX server's compiled
    graph computes them (XLA multiplies by the reciprocals), over every code;
    float frames pass through."""
    rgb = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1)
    dep = np.arange(65536, dtype=np.uint16).reshape(1, 256, 256)
    want = jax.jit(lambda a, b: (a.astype(jnp.float32) / 255.0,
                                 b.astype(jnp.float32) / 1000.0))(rgb, dep)
    got = dequantize_wire(torch.from_numpy(rgb), torch.from_numpy(dep))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and np.array_equal(g.numpy(), np.asarray(w))
    floats = (torch.zeros(1, 2, 2, 3), torch.zeros(1, 2, 2))
    assert all(a is b for a, b in zip(dequantize_wire(*floats), floats))


def test_static_quant_server_calibrate_and_persist(tmp_path):
    """A quant='static' server calibrates on representative frames before
    start(), saves its scales under the JAX package's npz keys, and a second
    server whose scales come back from that file serves identical results."""
    cfg = _static(_cfg(pconfig, score_thresh=0.0))
    frames = [_frame(300 + i) for i in range(4)]
    s1 = _server(cfg)
    s1.calibrate(np.stack([f[0] for f in frames]), np.stack([f[1] for f in frames]))
    path = str(tmp_path / "calib.npz")
    assert save_calibration(path, s1.pipe) == 113
    with np.load(path) as data:
        assert "detector/quant_stats/backbone/layer1_0/conv1/act_amax" in data.files

    uncalibrated = {k: (torch.zeros_like(v) if k.endswith("act_amax") else v)
                    for k, v in s1.pipe.state_dict().items()}
    s2 = _server(cfg, state_dict=uncalibrated)
    s2.load_calibration(path)
    s1.start()
    s2.start()
    try:
        for fid, (rgb, dep) in enumerate(frames):
            s1.submit(0, fid, rgb, dep)
            s2.submit(0, fid, rgb, dep)
        got1, got2 = {}, {}
        for _ in frames:
            _, fid, out = s1.get(timeout=120)
            got1[fid] = out
            _, fid, out = s2.get(timeout=120)
            got2[fid] = out
    finally:
        s1.stop()
        s2.stop()
    for fid in got1:
        assert np.isfinite(got1[fid]["joints_uvd"]).all()
        assert np.array_equal(got2[fid]["joints_uvd"], got1[fid]["joints_uvd"])


def test_static_quant_server_refuses_uncalibrated_start():
    s = _server(_static(CFG))
    with pytest.raises(ValueError, match="never calibrated"):
        s.start()


def test_bucketed_server_routes_and_matches_full_batch():
    """A partial microbatch routes to the SMALLEST bucket that fits it, and
    the served numbers equal the single-bucket server's on the same weights
    (to 1e-5: another batch size may take another convolution algorithm)."""
    buck = _server(batch_size=8, batch_buckets=(1, 2, 8))
    mono = _server(batch_size=8, state_dict=buck.pipe.state_dict())
    assert buck.batch_buckets == (1, 2, 8)

    # routing: drive the dispatcher directly (the queue's microbatch sizes
    # depend on the feeder's timing)
    frames = [_frame(400 + i) for i in range(3)]
    for n_items, want_bucket in ((1, 1), (2, 2), (3, 8)):
        items = [(0, i, *_wire(frames[i]), time.perf_counter()) for i in range(n_items)]
        buck._complete(buck._dispatch(items))
        assert buck.bucket_dispatches[want_bucket] == 1
    assert sum(buck.bucket_dispatches.values()) == 3

    got_b = {}
    while not buck.results.empty():
        _, fid, out = buck.results.get()
        got_b.setdefault(fid, []).append(out)

    mono.start()
    try:
        for fid, (rgb, dep) in enumerate(frames):
            mono.submit(0, fid, rgb, dep)
        for _ in frames:
            _, fid, out = mono.get(timeout=120)
            for served in got_b[fid]:
                assert_close(served["joints_uvd"], out["joints_uvd"], rtol=1e-5, atol=1e-5)
    finally:
        mono.stop()


def test_bucketed_server_end_to_end_trickle():
    """A single trickled frame through a bucketed server comes back (the
    batch-1 forward serves), and the top bucket still carries full batches."""
    s = _server(batch_buckets=(1,), flush_timeout=0.01).start()
    try:
        rgb, dep = _frame(500)
        s.submit("t", 0, rgb, dep)
        sid, fid, out = s.get(timeout=60)
        assert (sid, fid) == ("t", 0)
        assert np.isfinite(out["joints_uvd"]).all()
        for i in range(8):   # a burst: the batch-4 top bucket serves too
            s.submit("b", i, rgb, dep)
        for _ in range(8):
            s.get(timeout=60)
        assert s.bucket_dispatches[1] >= 1
        assert sum(s.bucket_dispatches.values()) >= 2
        stats = s.latency_stats()
        assert stats["count"] == 9
        assert 0 < stats["p50_ms"] <= stats["p99_ms"] <= stats["max_ms"]
        assert s.sustained_fps > 0
    finally:
        s.stop()


def test_failed_batch_returns_error_results_and_server_survives():
    """A batch that fails at dispatch or at the readback comes back as
    per-frame {"error": ...} results; the serve thread stays alive and later
    batches serve normally."""
    s = _server(flush_timeout=0.01)
    real_fwd = s._fwd
    state = {"fail_next": 0}

    def flaky(images, depth):
        if state["fail_next"]:
            state["fail_next"] -= 1
            raise RuntimeError("injected device failure")
        return real_fwd(images, depth)

    s.start()
    s._fwd = flaky
    state["fail_next"] = 1
    try:
        rgb, dep = _frame(600)
        s.submit(0, 0, rgb, dep)
        sid, fid, out = s.get(timeout=60)
        assert (sid, fid) == (0, 0)
        assert "error" in out and "injected device failure" in out["error"]
        assert s.error_count == 1
        s.submit(0, 1, rgb, dep)
        _, fid, out = s.get(timeout=60)
        assert fid == 1 and np.isfinite(out["joints_uvd"]).all()

        class Boom:  # the readback fails
            def items(self):
                raise RuntimeError("injected readback failure")

        s._fwd = lambda images, depth: Boom()
        s.submit(0, 2, rgb, dep)
        _, fid, out = s.get(timeout=60)
        assert fid == 2 and "injected readback failure" in out["error"]
        assert s.error_count == 2
        s._fwd = real_fwd
        s.submit(0, 3, rgb, dep)
        _, fid, out = s.get(timeout=60)
        assert fid == 3 and np.isfinite(out["joints_uvd"]).all()
    finally:
        s.stop()


def test_bucket_validation():
    with pytest.raises(ValueError, match="batch_buckets"):
        _server(batch_buckets=(1, 16))  # 16 > batch_size
    with pytest.raises(ValueError, match="batch_buckets"):
        _server(batch_buckets=(0, 2))


def test_mesh_is_refused():
    """What a server's mesh refuses: an object that is not a
    ``parallel.DataMesh``, a device beside the mesh's, a bucket that does
    not divide over it, and an artifact server with any mesh, as the JAX
    package's export refuses one (tests/test_torch_port_parallel.py serves
    through a mesh)."""
    from handnet_tpu_torch.parallel import create_mesh

    def meshed(mesh, **kw):
        return PipelineServer(CFG, frame_hw=HW, dtype=torch.float32, batch_size=4, mesh=mesh,
                              **kw)

    with pytest.raises(TypeError, match="DataMesh"):
        meshed(object())
    with pytest.raises(ValueError, match="device=None"):
        meshed(create_mesh(2, device="cpu"), device="cpu")
    with pytest.raises(ValueError, match="divide over mesh size 2"):
        meshed(create_mesh(2, device="cpu"), batch_buckets=(1, 4))
    with pytest.raises(ValueError, match="single-device"):
        PipelineServer.from_artifact("unused", mesh=object())


def test_bucket_graphs_serializes_its_callers():
    """Two host threads call one BucketGraphs (a server built from an
    artifact shares the artifact's graphs with ``predict``): each gets the
    outputs of its own frames. The fake forward stages its input in one
    shared buffer, as a captured graph reads its static buffers, and yields
    between the copy in and the read back: only the run lock keeps two
    calls from reading each other's frames."""
    staged = torch.zeros(2, 4, 6, 3)

    def forward(images, depth):
        staged.copy_(images)
        time.sleep(0.0005)
        return {"first": staged[:, 0, 0, 0].clone(), "depth": depth[:, 0, 0].clone()}

    graphs = BucketGraphs(forward, (4, 6), False, "cpu")
    wrong = []

    def caller(value):
        images = torch.full((2, 4, 6, 3), float(value))
        depth = torch.full((2, 4, 6), float(value))
        for _ in range(40):
            out = graphs.run(2, images, depth, fields=("first",))
            if sorted(out) != ["first"] or not bool((out["first"] == value).all()):
                wrong.append((value, out["first"].tolist()))

    threads = [threading.Thread(target=caller, args=(v,)) for v in (1, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not wrong, wrong[:3]


def test_server_matches_jax_server():
    """The port's server and JAX's on the same frames and weights (the port's
    seeded init, read by JAX through convert_fcos/convert_a2j), score
    threshold 0 so that every frame takes the found path. Tolerances of
    test_torch_port_pipeline.py: found and boxes exact, scores to 1e-5,
    joints to 1e-3 px."""
    pipe = HandNetPipeline(_cfg(pconfig, score_thresh=0.0), device="cpu", seed=2)
    sd = {k: v.numpy() for k, v in pipe.state_dict().items()}
    flax_vars = {part: conv({k[len(part) + 1:]: v for k, v in sd.items()
                             if k.startswith(part + ".")})
                 for part, conv in (("detector", convert_fcos), ("a2j", convert_a2j))}
    port = _server(_cfg(pconfig, score_thresh=0.0), state_dict=pipe.state_dict()).start()
    ref = JaxServer(_cfg(jconfig, score_thresh=0.0), batch_size=4, frame_hw=HW,
                    variables=jax.tree_util.tree_map(jnp.asarray, flax_vars),
                    dtype=jnp.float32).start()
    frames = [_frame(800 + i) for i in range(6)]
    try:
        got = {}
        for name, s in (("port", port), ("jax", ref)):
            feeder = threading.Thread(target=lambda s=s: [s.submit(0, i, *f)
                                                          for i, f in enumerate(frames)])
            feeder.start()
            got[name] = dict((fid, out) for _, fid, out in
                             (s.get(timeout=300) for _ in frames))
            feeder.join()
    finally:
        port.stop()
        ref.stop()
    for fid in range(len(frames)):
        p, j = got["port"][fid], got["jax"][fid]
        assert sorted(p) == sorted(j) == ["boxes", "found", "joints_uvd", "scores"]
        assert p["found"] and j["found"]
        assert np.array_equal(p["boxes"], np.asarray(j["boxes"]))
        assert_close(p["scores"], j["scores"], rtol=1e-5, atol=1e-6)
        assert_close(p["joints_uvd"], j["joints_uvd"], rtol=1e-4, atol=1e-3)
