"""The port's deployment artifact (``handnet_tpu_torch/export.py``) and the
kernels as ``torch.library`` ops, which ``torch.export`` records.

The counterparts of ``tests/test_export.py``, at ``tests/test_serve.py``'s
sizes (a 64x96 detector on 60x80 frames, 48^2 crops, float32) on the CPU:
an artifact reproduces the live port pipeline exactly on the same device,
routes any request size through its buckets, enforces its wire format and
geometry, and loads and serves without model code. Exporting costs 10-20 s
per bucket here, so two module-scoped artifacts carry the tests: a float
one (buckets 1 and 4, quantized wire, restricted fields) and a calibrated
static-int8 one (bucket 4, float wire, ``with_xyz``).

No counterpart: ``test_flatten_roundtrip`` (the port's weights are a flat
state dict already) and ``test_gn_fast_variance_exports_portable``, which
tests flax's single-pass GroupNorm variance: the port has only the exact
two-pass statistics of its kernel (``config.py``).
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from handnet_tpu import export as jexport
from handnet_tpu_torch import config as pconfig
from handnet_tpu_torch.apps.serve import PipelineServer
from handnet_tpu_torch.convert.from_flax import load_params_npz
from handnet_tpu_torch.export import (MANIFEST_NAME, _NPZ_SAFE, ServingArtifact,
                                      _load_weights, _save_weights, export_pipeline)
from handnet_tpu_torch.graphs import dequantize_wire
from handnet_tpu_torch.models.pipeline import HandNetPipeline
from handnet_tpu_torch.nn.quant import QuantConv
from handnet_tpu_torch.ops import cuda_a2j, cuda_gn, cuda_int8_conv
from torch_port_fixtures import assert_close

REPO = Path(__file__).resolve().parent.parent
CFG = pconfig.HandNetConfig(
    a2j=pconfig.A2JConfig(crop_h=48, crop_w=48),
    fcos=pconfig.FCOSConfig(image_h=64, image_w=96, max_detections=8, num_classes=2,
                            ext=False, score_thresh=0.0),
    pipeline=pconfig.PipelineConfig(crop_size=48))
STATIC = dataclasses.replace(CFG, fcos=dataclasses.replace(CFG.fcos, quant="static"),
                             a2j=dataclasses.replace(CFG.a2j, quant="static"))
HW = (60, 80)
FIELDS = ("joints_uvd", "joints_uvd_full", "boxes", "found", "scores")


def _frames(n, seed, quantized):
    rng = np.random.default_rng(seed)
    rgb = rng.uniform(size=(n, *HW, 3)).astype(np.float32)
    depth = rng.uniform(0.3, 1.0, size=(n, *HW)).astype(np.float32)
    if quantized:
        return (rgb * 255).astype(np.uint8), (depth * 1000).astype(np.uint16)
    return rgb, depth


def _paras(n):
    return np.tile([600.0, 600.0, 40.0, 30.0], (n, 1)).astype(np.float32)


def _live(pipe, rgb, depth, bucket, paras=None, fields=None):
    """The live pipeline on the frames padded (zeros; paras with ones) to
    ``bucket``, cut back to the real frames."""
    n = len(rgb)
    pad = [(0, bucket - n)] + [(0, 0)] * (rgb.ndim - 1)
    args = dequantize_wire(torch.from_numpy(np.pad(rgb, pad)),
                           torch.from_numpy(np.pad(depth, pad[:-1])))
    if paras is not None:
        args += (torch.from_numpy(np.pad(paras, pad[:2], constant_values=1.0)),)
    out = pipe(*args)
    return {k: v[:n].numpy() for k, v in out.items() if fields is None or k in fields}


def _assert_equal(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].shape == want[key].shape and np.array_equal(got[key], want[key]), key


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tests run small forwards; one intra-op thread keeps them from
    crowding the other test processes, some of which time their own runs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def float_artifact(tmp_path_factory):
    """Buckets 1 and 4, uint8/uint16 wire, FIELDS only; the live pipeline."""
    pipe = HandNetPipeline(CFG, device="cpu", seed=2)
    out = str(tmp_path_factory.mktemp("aot") / "pipeline")
    export_pipeline(CFG, pipe.state_dict(), out, buckets=(4, 1), frame_hw=HW,
                    dtype=torch.float32, quantized_wire=True, out_fields=FIELDS, device="cpu")
    return ServingArtifact.load(out), pipe, out


@pytest.fixture(scope="module")
def int8_artifact(tmp_path_factory):
    """Calibrated static int8, bucket 4, float wire, with_xyz."""
    pipe = HandNetPipeline(STATIC, device="cpu", seed=2)
    rgb, depth = _frames(4, 30, quantized=False)
    pipe.calibrate(torch.from_numpy(rgb), torch.from_numpy(depth))
    out = str(tmp_path_factory.mktemp("aot") / "int8")
    export_pipeline(STATIC, pipe.state_dict(), out, buckets=(4,), frame_hw=HW,
                    dtype=torch.float32, with_xyz=True, device="cpu")
    return ServingArtifact.load(out), pipe


# ---------------------------------------------------------------------------
# the kernels as torch.library ops


def _op_cases():
    rng = np.random.default_rng(40)
    t = torch.from_numpy
    x = t(rng.normal(1.0, 2.0, size=(2, 3, 5, 64)).astype(np.float32))
    q = t(rng.integers(-127, 128, size=(2, 5, 6, 64), dtype=np.int8))
    stats = cuda_gn.gn_group_stats_reference(x, 32)
    return {
        "a2j_decode": (cuda_a2j.a2j_decode_reference,
                       (t(rng.normal(size=(2, 32, 4)).astype(np.float32)),
                        t(rng.normal(size=(2, 32, 4, 2)).astype(np.float32)),
                        t(rng.uniform(0.3, 1.0, size=(2, 32, 4)).astype(np.float32)),
                        t(rng.uniform(0, 48, size=(32, 2)).astype(np.float32)))),
        "a2j_decode_xy": (cuda_a2j.a2j_decode_xy_reference,
                          (t(rng.normal(size=(2, 32, 4)).astype(np.float32)),
                           t(rng.normal(size=(2, 32, 4, 2)).astype(np.float32)),
                           t(rng.uniform(0, 48, size=(32, 2)).astype(np.float32)))),
        "gn_group_stats": (cuda_gn.gn_group_stats_reference, (x, 32)),
        "gn_apply": (cuda_gn.gn_apply_reference,
                     (x, stats, t(rng.uniform(0.5, 1.5, 64).astype(np.float32)),
                      t(rng.normal(size=64).astype(np.float32)), 1e-5, True)),
        "int8_quantize": (cuda_int8_conv.quantize_activation,
                          (x, torch.tensor(0.05, dtype=torch.float32))),
        "int8_conv_gemm": (cuda_int8_conv.int8_conv_gemm_reference,
                           (q, t(rng.integers(-127, 128, size=(64, 3, 3, 64), dtype=np.int8)),
                            t(rng.uniform(0.01, 0.1, 2).astype(np.float32)),
                            t(rng.uniform(0.001, 0.01, 64).astype(np.float32)),
                            t(rng.normal(size=64).astype(np.float32)), [1, 1], [1, 1],
                            [1, 1], torch.float32)),
    }


OPS = ("a2j_decode", "a2j_decode_xy", "gn_group_stats", "gn_apply", "int8_quantize",
       "int8_conv_gemm")


@pytest.mark.parametrize("name", OPS)
def test_op_passes_opcheck(name):
    """Schema, fake (meta) implementation, and tracing under FakeTensors and
    dynamic shapes, as torch.export needs them."""
    _, args = _op_cases()[name]
    torch.library.opcheck(getattr(torch.ops.handnet_torch, name).default, args)


@pytest.mark.parametrize("name", OPS)
def test_op_cpu_is_plain_version(name):
    """On a CPU tensor the op, and the public wrapper that calls it, are the
    plain version bit for bit, and count no kernel launch."""
    plain, args = _op_cases()[name]
    wrapper = {"a2j_decode": cuda_a2j.a2j_decode, "a2j_decode_xy": cuda_a2j.a2j_decode_xy,
               "gn_group_stats": cuda_gn.gn_group_stats,
               "gn_apply": cuda_gn.gn_apply, "int8_quantize": cuda_int8_conv.int8_quantize,
               "int8_conv_gemm": cuda_int8_conv.int8_conv_gemm}[name]
    before = wrapper.launches
    want = plain(*args)
    assert torch.equal(getattr(torch.ops.handnet_torch, name)(*args), want)
    assert torch.equal(wrapper(*args), want)
    assert wrapper.launches == before


def test_npz_helpers_match_the_jax_package(tmp_path):
    """The port's copies of ``_NPZ_SAFE`` and ``load_params_npz`` equal the
    JAX package's (whose checkpoint module imports orbax)."""
    from handnet_tpu.train.checkpoints import load_params_npz as jload
    from handnet_tpu.train.checkpoints import save_params_npz

    assert _NPZ_SAFE == jexport._NPZ_SAFE
    tree = {"backbone": {"conv1": {"kernel": np.arange(6.0).reshape(1, 2, 3)}},
            "head": {"bias": np.ones(3, np.float32)}}
    path = str(tmp_path / "params.npz")
    save_params_npz(path, tree)
    got, want = load_params_npz(path), jload(path)
    assert got.keys() == want.keys() == tree.keys()
    np.testing.assert_array_equal(got["backbone"]["conv1"]["kernel"],
                                  want["backbone"]["conv1"]["kernel"])
    np.testing.assert_array_equal(got["head"]["bias"], tree["head"]["bias"])


def test_weights_round_trip_with_bf16_dtype_map(tmp_path):
    """A bf16 pipeline's state dict: bf16 tensors are stored as float32 and
    named in the dtype map, and every tensor comes back bit for bit."""
    state = HandNetPipeline(CFG, dtype=torch.bfloat16, device="cpu").state_dict()
    path = str(tmp_path / "weights.npz")
    dtype_map = _save_weights(path, state)
    assert dtype_map == {k: "bfloat16" for k, v in state.items() if v.dtype == torch.bfloat16}
    assert dtype_map and len(dtype_map) < len(state)
    back = _load_weights(path, dtype_map)
    assert list(back) == list(state)
    for key, value in state.items():
        assert back[key].dtype == value.dtype and torch.equal(back[key], value), key


# ---------------------------------------------------------------------------
# the artifact


def test_artifact_matches_live_pipeline(float_artifact):
    art, pipe, _ = float_artifact
    rgb, depth = _frames(4, 1, quantized=True)
    _assert_equal(art.predict(rgb, depth), _live(pipe, rgb, depth, 4, fields=FIELDS))


def test_bucket_routing_pads_and_chunks(float_artifact):
    """n=1 -> bucket 1; n=3 -> bucket 4 (padded); n=7 -> 4, then 3 padded to
    4. Padding rows never leak into the returned frames."""
    art, pipe, _ = float_artifact
    for n, chunks in ((1, [(1, 1)]), (3, [(3, 4)]), (7, [(4, 4), (3, 4)])):
        rgb, depth = _frames(n, 10 + n, quantized=True)
        got = art.predict(rgb, depth)
        assert got["joints_uvd"].shape == (n, 21, 3)
        parts, start = [], 0
        for size, bucket in chunks:
            sl = slice(start, start + size)
            parts.append(_live(pipe, rgb[sl], depth[sl], bucket, fields=FIELDS))
            start += size
        _assert_equal(got, {k: np.concatenate([p[k] for p in parts]) for k in FIELDS})


def test_manifest_and_config_roundtrip(float_artifact):
    art, _, out = float_artifact
    with open(os.path.join(out, MANIFEST_NAME)) as f:
        manifest = json.load(f)
    assert manifest["buckets"] == [1, 4]
    assert manifest["device_type"] == "cpu"
    assert manifest["torch_version"] == torch.__version__
    assert manifest["compute_dtype"] == "float32"
    assert manifest["out_fields"] == list(FIELDS)
    assert sorted(os.listdir(os.path.join(out, "graphs"))) == ["b1.pt2", "b4.pt2"]
    assert art.config() == CFG
    assert art.buckets == (1, 4) and art.frame_hw == HW


def test_wrong_geometry_and_device_rejected(float_artifact):
    art, _, out = float_artifact
    with pytest.raises(ValueError, match="rgb must be"):
        art.predict(np.zeros((2, 64, 64, 3), np.uint8), np.zeros((2, 64, 64), np.uint16))
    with pytest.raises(ValueError, match="exported for cpu"):
        ServingArtifact.load(out, device="cuda")


def test_quantized_wire_artifact(float_artifact):
    """The programs take uint8 RGB and uint16 mm depth and equal the live
    dequantize-then-forward; only the exported fields come back."""
    art, pipe, _ = float_artifact
    assert art.quantized_wire and art.graphs.wire == (torch.uint8, torch.uint16)
    rgb, depth = _frames(2, 2, quantized=True)
    got = art.predict(rgb, depth)
    assert sorted(got) == sorted(FIELDS)
    _assert_equal(got, _live(pipe, rgb, depth, 4, fields=FIELDS))


def test_with_xyz_artifact_requires_paras(int8_artifact):
    art, pipe = int8_artifact
    rgb, depth = _frames(4, 3, quantized=False)
    got = art.predict(rgb, depth, _paras(4))
    assert_close(got["joints_xyz"], _live(pipe, rgb, depth, 4, _paras(4))["joints_xyz"],
                 rtol=0, atol=0)
    with pytest.raises(ValueError, match="requires paras"):
        art.predict(rgb, depth)


def test_static_int8_export_requires_calibration(tmp_path):
    pipe = HandNetPipeline(STATIC, device="cpu")
    with pytest.raises(ValueError, match="calibrat"):
        export_pipeline(STATIC, pipe.state_dict(), str(tmp_path / "q"), buckets=(2,),
                        frame_hw=HW, dtype=torch.float32, device="cpu")


def test_static_int8_calibrated_export_matches(int8_artifact):
    """Every output of the calibrated int8 artifact equals the live int8
    pipeline's: the loader quantizes the float weights as the live layers
    do, and the int8 steps are the ops' plain versions."""
    art, pipe = int8_artifact
    rgb, depth = _frames(4, 4, quantized=False)
    got = art.predict(rgb, depth, _paras(4))
    assert np.isfinite(got["joints_uvd"]).all() and got["found"].all()
    _assert_equal(got, _live(pipe, rgb, depth, 4, _paras(4)))


def test_int8_program_takes_quantized_weights(int8_artifact):
    """The int8 program quantizes no weight: the loader quantizes each int8
    layer's float weight once, as the live layers cache theirs, and the
    program takes the pairs as arguments (its only roundings are the int8
    ops' own)."""
    art, pipe = int8_artifact
    layers = [name for name, m in pipe.named_modules() if isinstance(m, QuantConv)]
    assert art.manifest["quantized_layers"] == layers and list(art.qweights) == layers
    for name in layers:
        want = pipe.get_submodule(name).quantized_weight()
        assert all(torch.equal(g, w) for g, w in zip(art.qweights[name], want)), name
    targets = {str(n.target) for n in art._programs[4].graph.nodes if n.op == "call_function"}
    assert "handnet_torch.int8_conv_gemm.default" in targets
    assert not [t for t in targets if "round" in t], targets


def test_pad_exceeds_partial_batch(int8_artifact):
    """Bucket 4, n=1: the padding (3 rows) outnumbers the frames, which
    ``zeros_like(rgb[:pad])`` would get wrong; the padding never leaks."""
    art, pipe = int8_artifact
    rgb, depth = _frames(1, 5, quantized=False)
    got = art.predict(rgb, depth, _paras(1))
    assert got["joints_uvd"].shape == (1, 21, 3)
    _assert_equal(got, _live(pipe, rgb, depth, 4, _paras(1)))


def test_server_from_artifact(float_artifact):
    """A server built from an artifact serves its programs end to end; the
    ladder, geometry and wire format come from the manifest. (Frames that
    ride another bucket than the live call's may take another convolution
    algorithm: 1e-5.)"""
    art, pipe, _ = float_artifact
    server = PipelineServer.from_artifact(art, out_fields=("joints_uvd", "found"),
                                          flush_timeout=0.001)
    assert server.pipe is None
    assert server.batch_buckets == (1, 4) and server.frame_hw == HW
    assert server.quantized_transfer
    rgb, depth = _frames(3, 6, quantized=True)
    server.start()
    try:
        for i in range(3):
            server.submit(0, i, rgb[i], depth[i])
        results = {}
        for _ in range(3):
            _, fid, res = server.get(timeout=60)
            assert "error" not in res and sorted(res) == ["found", "joints_uvd"]
            results[fid] = res
    finally:
        server.stop()
    want = _live(pipe, rgb, depth, 4)
    for i in range(3):
        assert_close(results[i]["joints_uvd"], want["joints_uvd"][i], rtol=1e-5, atol=1e-5)


def test_server_from_artifact_rejects_unexported_field(float_artifact, int8_artifact):
    _, _, out = float_artifact
    with pytest.raises(ValueError, match="does not emit"):
        PipelineServer.from_artifact(out, out_fields=("joints_uvd", "sides"))
    with pytest.raises(ValueError, match="no intrinsics"):
        PipelineServer.from_artifact(int8_artifact[0])


_FRESH_SCRIPT = """
import sys
import numpy as np
from handnet_tpu_torch.export import ServingArtifact
from handnet_tpu_torch.apps.serve import PipelineServer

path, rgb_path = sys.argv[1], sys.argv[2]
frames = np.load(rgb_path)
art = ServingArtifact.load(path)
np.savez(path + "/fresh.npz", **art.predict(frames["rgb"], frames["depth"]))
server = PipelineServer.from_artifact(art).start()
server.submit("s", 0, frames["rgb"][0], frames["depth"][0])
_, _, out = server.get(timeout=120)
server.stop()
assert "error" not in out and np.isfinite(out["joints_uvd"]).all()
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "handnet_tpu")
                or m.startswith("handnet_tpu_torch.models"))
print("LOADED", loaded)
"""


def test_fresh_interpreter_loads_without_model_code(float_artifact, tmp_path):
    """A fresh interpreter loads the artifact, predicts and serves with
    neither jax, the JAX package nor ``handnet_tpu_torch.models`` loaded;
    its predictions equal the live pipeline's (a subprocess:
    tests/conftest.py imports jax into this one)."""
    _, pipe, out = float_artifact
    rgb, depth = _frames(3, 7, quantized=True)
    np.savez(tmp_path / "frames.npz", rgb=rgb, depth=depth)
    # one intra-op thread, as here: the CPU convolutions' bits depend on it
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-c", _FRESH_SCRIPT, out,
                           str(tmp_path / "frames.npz")],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().splitlines()[-1] == "LOADED []", proc.stdout
    with np.load(os.path.join(out, "fresh.npz")) as data:
        _assert_equal({k: data[k] for k in data.files},
                      _live(pipe, rgb, depth, 4, fields=FIELDS))
