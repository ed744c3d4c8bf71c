"""The port's demo apps (``apps/demo.py``, ``apps/a2j_mesh.py``,
``apps/ros_node.py``) and ``utils/raster.py`` against the JAX package's.

The JAX apps' ``main`` functions are not called: each inits the full-width
flax models eagerly (about 55 s on a CPU). The JAX side instead runs its own
functions on the same weights: its ``HandNetPipeline`` (jitted, float32)
and ``A2JSystem.predict`` on variables that its own converters
(``convert_fcos``/``convert_a2j`` of ``load_torch_checkpoint``) read from
the reference-keyed checkpoints the port's apps load, its
``build_mesh_head`` with ``Pose2Mesh.init`` patched to return the port's
mesh head's variables (``pose2mesh_variables_from_state_dict``), its
``SyntheticSource``, ``convert_joints`` and ``_write_overlay``, and the
JAX demo loop's own arithmetic, replayed line for line.

The demo is held in float32: the app builds its pipeline in bf16, as JAX's
does, and the ``built_pipeline`` fixture answers that build with a float32
one, since JAX's and the port's bf16 forwards round apart. Sizes: 48x64 frames, a 48x64 detector, 32^2 crops
(the JAX package's own demo smoke test); the A2J mesh app at crop 48 on the
port's synthetic DexYCB tree. Tolerances: joints within ``JOINT_TOL`` of
the UVD's range (and of XYZ's), boxes within 1e-3 px, mesh vertices within
``MESH_TOL`` of their magnitude; found, side and the npz keys exact; the
overlays' pixels equal.
"""

import os
import queue
import sys
import time

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from handnet_tpu import config as jconfig
from handnet_tpu.apps import demo as jdemo
from handnet_tpu.apps import ros_node as jros
from handnet_tpu.convert import torch_weights as jtw
from handnet_tpu.models import pose2mesh as jp2m
from handnet_tpu.models.pipeline import HandNetPipeline as JaxPipeline
from handnet_tpu.ops import geometry as jgeometry
from handnet_tpu.utils import raster as jraster
from handnet_tpu_torch import config as pconfig
from handnet_tpu_torch.apps import a2j_mesh, demo, ros_node
from handnet_tpu_torch.convert.from_flax import pose2mesh_variables_from_state_dict
from handnet_tpu_torch.data import image_io
from handnet_tpu_torch.models.pipeline import HandNetPipeline
from handnet_tpu_torch.utils import raster
from torch_port_fixtures import assert_close, fast_compile

H, W, CROP, FRAMES = 48, 64, 32, 2
PARAS = np.array([600.0, 600.0, 320.0, 240.0], np.float32)
JOINT_TOL = 1e-4
MESH_TOL = 1e-3
DEMO_ARGS = ["--frames", str(FRAMES), "--size", str(H), str(W), "--net-size", str(H), str(W),
             "--crop", str(CROP), "--score-thresh", "0.0", "--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# utils/raster.py

K = np.array([[300.0, 0, 64], [0, 300.0, 48], [0, 0, 1]])


def _square(z=500.0, half=100.0, tilt=0.0):
    """``tests/test_raster.py``'s two-triangle square."""
    v = np.array([[-half, -half, z - tilt * half], [half, -half, z + tilt * half],
                  [half, half, z + tilt * half], [-half, half, z - tilt * half]])
    return v, np.array([[0, 1, 2], [0, 2, 3]])


def _occlusion():
    v1, f1 = _square(400.0, 50.0)
    v2, f2 = _square(800.0, 120.0)
    return np.concatenate([v1, v2]), np.concatenate([f1, f2 + 4])


def _hand_sized_mesh():
    """778 vertices on a bumpy disc 450 mm away, the strip stand-in's
    faces (the demo's overlay geometry)."""
    rng = np.random.default_rng(11)
    r = np.sqrt(rng.uniform(0, 1, 778)) * 80.0
    a = rng.uniform(0, 2 * np.pi, 778)
    v = np.stack([r * np.cos(a), r * np.sin(a), 450.0 + rng.normal(0, 10, 778)], axis=1)
    return v, np.stack([np.arange(776), np.arange(1, 777), np.arange(2, 778)], axis=1)


SCENES = {"tilted": lambda: _square(500.0, tilt=0.4), "occlusion": _occlusion,
          "behind": lambda: _square(-500.0), "mesh778": _hand_sized_mesh}


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_raster_matches_jax(scene):
    """``render_depth`` and ``render_mesh_overlay`` (a uint8 frame, and a
    float frame with a depth test) bit-equal to the JAX package's."""
    v, f = SCENES[scene]()
    depth = raster.render_depth(v, f, K, 96, 128)
    assert np.array_equal(depth, jraster.render_depth(v, f, K, 96, 128))
    assert (depth > 0).any() == (scene != "behind")
    rng = np.random.default_rng(1)
    frame8 = rng.integers(0, 256, (96, 128, 3)).astype(np.uint8)
    scene_depth = np.where(rng.uniform(size=(96, 128)) < 0.5, 0.0, 480.0)
    for frame, kw in ((frame8, {}), (frame8.astype(np.float32) / 255.0,
                                      {"depth_test": scene_depth})):
        got = raster.render_mesh_overlay(frame, v, f, K, **kw)
        want = jraster.render_mesh_overlay(frame, v, f, K, **kw)
        assert got.dtype == want.dtype == frame.dtype and np.array_equal(got, want)


# ---------------------------------------------------------------------------
# apps/demo.py: frame sources

def test_synthetic_source_matches_jax():
    got = list(demo.SyntheticSource(3, h=20, w=30, seed=4).frames())
    want = list(jdemo.SyntheticSource(3, h=20, w=30, seed=4).frames())
    assert len(got) == len(want) == 3
    for (g_rgb, g_d), (w_rgb, w_d) in zip(got, want):
        assert g_rgb.dtype == w_rgb.dtype == np.float32 and np.array_equal(g_rgb, w_rgb)
        assert g_d.dtype == w_d.dtype == np.float32 and np.array_equal(g_d, w_d)


def test_folder_source_matches_jax(tmp_path):
    """color_*.jpg (the port's encoder) and 16-bit depth_*.png: the port's
    reads equal the JAX source's ``cv2.imread`` bit for bit; a mismatched
    count exits as JAX's does."""
    rng = np.random.default_rng(5)
    for i in range(3):
        image_io.imwrite_jpeg(tmp_path / f"color_{i:03d}.jpg",
                              rng.integers(0, 256, (17, 23, 3)).astype(np.uint8))
        image_io.write_png(tmp_path / f"depth_{i:03d}.png",
                           rng.integers(0, 3000, (17, 23)).astype(np.uint16))
    got = list(demo.FolderSource(str(tmp_path)).frames())
    want = list(jdemo.FolderSource(str(tmp_path)).frames())
    assert len(got) == len(want) == 3
    for (g_rgb, g_d), (w_rgb, w_d) in zip(got, want):
        assert g_rgb.dtype == np.float32 and np.array_equal(g_rgb, w_rgb)
        assert g_d.dtype == np.float32 and np.array_equal(g_d, w_d)
    os.remove(tmp_path / "depth_000.png")
    with pytest.raises(SystemExit, match="mismatched"):
        demo.FolderSource(str(tmp_path))


# ---------------------------------------------------------------------------
# apps/demo.py: the loop, against the JAX demo's

@pytest.fixture(scope="module")
def port_pipeline():
    """A seeded port pipeline at the demo's test geometry (float32, CPU), as
    the demo configures it for a reference A2J checkpoint (transposed
    anchors)."""
    cfg = demo.build_config(demo.parse_args(DEMO_ARGS + ["--a2j-checkpoint", "a2j.pth"]))
    assert cfg.a2j.transposed_anchors
    return HandNetPipeline(cfg, seed=2, device="cpu")


@pytest.fixture
def built_pipeline(port_pipeline, monkeypatch):
    """The demo's ``HandNetPipeline`` answers with a float32 copy of the
    fixture's (building the full-width ResNets costs about 2 s a time on a
    CPU; the checkpoints then overwrite every weight), after checking the
    arguments the app passes: bf16, the app's only dtype."""
    import copy

    def build(cfg, dtype, device, use_kernels, seed):
        assert cfg == port_pipeline.cfg and dtype == torch.bfloat16 and device == torch.device(
            "cpu") and use_kernels and seed == 0
        return copy.deepcopy(port_pipeline)

    monkeypatch.setattr(demo, "HandNetPipeline", build)


@pytest.fixture(scope="module")
def checkpoints(port_pipeline, tmp_path_factory):
    """Reference-keyed FCOS and A2J checkpoints of the seeded port pipeline
    (what ``--fcos-checkpoint``/``--a2j-checkpoint`` read)."""
    d = tmp_path_factory.mktemp("ckpt")
    sd = port_pipeline.state_dict()
    paths = {}
    for part in ("detector", "a2j"):
        paths[part] = str(d / f"{part}.pth")
        torch.save({k[len(part) + 1:]: v for k, v in sd.items() if k.startswith(part + ".")},
                   paths[part])
    return paths


@pytest.fixture(scope="module")
def mesh_heads():
    """The port's mesh head, and JAX's ``build_mesh_head`` with its
    ``Pose2Mesh.init`` returning the port head's weights."""
    port_head, faces = demo.build_mesh_head()
    variables = pose2mesh_variables_from_state_dict(port_head.model.state_dict())
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jp2m.Pose2Mesh, "init", lambda self, *a, **k: variables)
        jax_head, jax_faces = jdemo.build_mesh_head()
    assert np.array_equal(faces, jax_faces)
    return port_head, jax_head, faces


@pytest.fixture
def built_head(mesh_heads, monkeypatch):
    """The apps' ``build_mesh_head`` answers with the fixture's head (the
    build is seeded, so it would build the same one; building the
    4096-wide lifter costs about 2 s a time on a CPU), after checking the
    arguments the app passes."""
    port_head, _, faces = mesh_heads

    def build(mano_assets=None, device="cpu"):
        assert mano_assets is None and torch.device(device) == torch.device("cpu")
        return port_head, faces

    monkeypatch.setattr(demo, "build_mesh_head", build)


@pytest.fixture(scope="module")
def jax_forward(checkpoints):
    """JAX's demo pipeline at the test geometry, float32, jitted, on the
    checkpoints' weights as its converters read them."""
    cfg = jconfig.HandNetConfig(
        fcos=jconfig.FCOSConfig(num_classes=3, ext=False, image_h=H, image_w=W,
                                score_thresh=0.0),
        a2j=jconfig.A2JConfig(transposed_anchors=True, crop_h=CROP, crop_w=CROP),
        pipeline=jconfig.PipelineConfig(crop_size=CROP))
    pipe = JaxPipeline(cfg, dtype=jnp.float32)
    variables = {
        "detector": jax.tree_util.tree_map(jnp.asarray, jtw.convert_fcos(
            jtw.load_torch_checkpoint(checkpoints["detector"]))),
        "a2j": jax.tree_util.tree_map(jnp.asarray, jtw.convert_a2j(
            jtw.load_torch_checkpoint(checkpoints["a2j"]))),
    }
    paras = jnp.asarray(PARAS[None])
    fwd = jax.jit(lambda v, im, d: pipe(v, im, d, paras))
    return lambda im, d: fwd(variables, im, d)


def jax_demo_loop(fwd, mesh_fn, faces, flip_left, overlay_dir):
    """``handnet_tpu/apps/demo.py:164-221`` on the synthetic source."""
    results = []
    for i, (rgb, depth) in enumerate(jdemo.SyntheticSource(FRAMES, h=H, w=W).frames()):
        rgb_disp = rgb
        if flip_left:
            rgb = rgb[:, ::-1].copy()
            depth = depth[:, ::-1].copy()
        out = fwd(jnp.asarray(rgb[None]), jnp.asarray(depth[None]))
        r = {"joints_uvd": np.asarray(out["joints_uvd"][0]),
             "joints_xyz": np.asarray(out["joints_xyz"][0]),
             "box": np.asarray(out["boxes"][0]),
             "found": bool(np.asarray(out["found"][0])),
             "side": int(np.asarray(out["sides"][0]))}
        if flip_left and r["found"]:
            w = rgb.shape[1]
            x1, y1, x2, y2 = r["box"]
            r["box"] = np.array([w - 1 - x2, y1, w - 1 - x1, y2], np.float32)
            uvd = r["joints_uvd"].copy()
            uvd[:, 0] = (CROP - 1) - uvd[:, 0]
            r["joints_uvd"] = uvd
            r["joints_xyz"] = np.asarray(jgeometry.convert_joints(
                uvd[None], r["box"][None], PARAS[None], CROP, CROP))[0]
        if mesh_fn is not None and r["found"]:
            verts = np.asarray(mesh_fn(np.asarray(out["joints_uvd"][0])[:, :2]))
            if flip_left:
                verts = verts * np.array([-1.0, 1.0, 1.0], np.float32)
            r["mesh"] = verts
            jdemo._write_overlay(overlay_dir, i, rgb_disp, verts, faces, r["joints_xyz"],
                                 list(PARAS))
        results.append(r)
    return results


@pytest.mark.parametrize("mode", ["plain", "flip_left_render_mesh"])
def test_demo_main_matches_jax(mode, checkpoints, jax_forward, mesh_heads, built_head,
                               built_pipeline, tmp_path):
    """The port's ``demo.main`` npz against JAX's demo loop on the same
    frames and weights: found and side exact, boxes within 1e-3 px, joints
    within ``JOINT_TOL`` of their range, meshes within ``MESH_TOL``; with
    ``--flip-left --render-mesh`` the saved (box, uvd, xyz) triple is
    self-consistent and each overlay's pixels equal those of JAX's
    ``_write_overlay`` (a PNG written by cv2), read back with cv2."""
    extra = ["--flip-left", "--render-mesh"] if mode != "plain" else []
    out = tmp_path / "port" / "res.npz"
    os.makedirs(out.parent)
    res = demo.main(DEMO_ARGS + extra + ["--out", str(out), "--fcos-checkpoint",
                                         checkpoints["detector"], "--a2j-checkpoint",
                                         checkpoints["a2j"]])
    port_head, jax_head, faces = mesh_heads
    (tmp_path / "jax").mkdir()
    want = jax_demo_loop(jax_forward, jax_head if extra else None, faces, bool(extra),
                         str(tmp_path / "jax"))
    got = np.load(out)
    keys = {f"frame{i:04d}_{k}" for i, r in enumerate(want) for k in r}
    assert set(got.files) == keys and res["found"] == sum(r["found"] for r in want) == FRAMES
    uvd_scale = max(np.ptp(r["joints_uvd"]) for r in want)
    xyz_scale = max(np.ptp(r["joints_xyz"]) for r in want)
    for i, w in enumerate(want):
        g = {k: got[f"frame{i:04d}_{k}"] for k in w}
        assert bool(g["found"]) == w["found"] and int(g["side"]) == w["side"]
        assert_close(g["box"], w["box"], rtol=0, atol=1e-3)
        assert_close(g["joints_uvd"], w["joints_uvd"], rtol=0, atol=JOINT_TOL * uvd_scale)
        assert_close(g["joints_xyz"], w["joints_xyz"], rtol=0, atol=JOINT_TOL * xyz_scale)
        if "mesh" in w:
            assert g["mesh"].shape == (778, 3)
            assert_close(g["mesh"], w["mesh"], rtol=0,
                         atol=MESH_TOL * np.abs(w["mesh"]).max())
    if extra:
        for i in range(FRAMES):
            g = {k: got[f"frame{i:04d}_{k}"] for k in ("joints_uvd", "box", "joints_xyz")}
            again = jgeometry.convert_joints(g["joints_uvd"][None], g["box"][None],
                                             PARAS[None], CROP, CROP)
            assert_close(g["joints_xyz"], np.asarray(again)[0], rtol=1e-6, atol=1e-3)
            name = f"overlay_{i:04d}.png"
            port_png = cv2.imread(str(tmp_path / "port" / name))
            assert np.array_equal(port_png, cv2.imread(str(tmp_path / "jax" / name)))
            assert np.array_equal(image_io.read_png(tmp_path / "port" / name), port_png)
        assert res["overlay_ms"] is not None


def test_build_mesh_head_matches_jax(mesh_heads):
    """The pyramid (perm, perm_reverse and sizes exact, Laplacians to 1e-5:
    ARPACK's start differs) and the head's vertices from the same joints."""
    port_head, jax_head, _ = mesh_heads
    from handnet_tpu.ops.graph import build_graph_pyramid as jbuild
    from handnet_tpu_torch.ops.graph import HAND_SKELETON

    faces = np.stack([np.arange(776), np.arange(1, 777), np.arange(2, 778)], axis=1)
    jp = jbuild(faces, 21, HAND_SKELETON, levels=6)
    pp = port_head.pyramid
    assert pp.mesh_sizes == jp.mesh_sizes
    assert np.array_equal(pp.perm, jp.perm) and np.array_equal(pp.perm_reverse, jp.perm_reverse)
    for a, b in zip(pp.laplacians, jp.laplacians):
        assert_close(a, b, rtol=0, atol=1e-5)
    joints = np.random.default_rng(3).uniform(0, 32, (21, 2)).astype(np.float32)
    got, jv = port_head(joints), np.asarray(jax_head(joints))
    assert got.shape == jv.shape == (778, 3) and got.dtype == np.float32
    assert_close(got, jv, rtol=0, atol=MESH_TOL * np.abs(jv).max())


# ---------------------------------------------------------------------------
# apps/a2j_mesh.py

def test_a2j_mesh_matches_jax(tmp_path, checkpoints, mesh_heads, built_head):
    """``a2j_mesh.main`` on the port's synthetic tree against JAX's
    ``A2JSystem.predict``, clip, ``convert_joints`` and post-transform on
    the JAX data source's samples of the same tree, the same weights (the
    demo's reference-keyed A2J checkpoint) and the same mesh head: joints
    within 1e-5 of their magnitude, meshes within ``MESH_TOL``."""
    from handnet_tpu.data.a2j_data import A2JDataSource as JSource
    from handnet_tpu.data.a2j_data import A2JSampleConfig as JSampleConfig
    from handnet_tpu.data.dexycb import DexYCBDataset as JDataset
    from handnet_tpu.data.dexycb import refine_indices as jrefine
    from handnet_tpu.models.a2j import A2JSystem as JA2J

    crop, limit, ckpt = 48, 2, checkpoints["a2j"]
    root, out = str(tmp_path / "tree"), str(tmp_path / "meshes.npz")
    got = a2j_mesh.main(["--synthetic", "1", "--data-dir", root, "--crop", str(crop), "--limit",
                         str(limit), "--a2j-checkpoint", ckpt, "--out", out, "--device", "cpu"])
    saved = np.load(out)
    assert sorted(saved.files) == sorted(got) == sorted(
        f"sample{i}_{k}" for i in range(limit) for k in ("joints_xyz", "mesh"))

    ds = JDataset("s0", "train", data_dir=root)
    src = JSource(ds, jrefine(ds)[:limit], augment=False,
                  cfg=JSampleConfig(crop_w=crop, crop_h=crop))
    jsys = JA2J(jconfig.A2JConfig(crop_h=crop, crop_w=crop, transposed_anchors=True))
    variables = jax.tree_util.tree_map(jnp.asarray, jtw.convert_a2j(jtw.load_torch_checkpoint(
        ckpt)))
    predict = fast_compile(jsys.predict, variables, jnp.zeros((1, crop, crop, 1)))
    _, jax_head, _ = mesh_heads
    for i in range(limit):
        sample = src[i]
        uvd = jnp.clip(predict(variables, jnp.asarray(sample["depth"][None])), 0, crop - 1)
        xyz = np.asarray(jgeometry.convert_joints(uvd, jnp.asarray(sample["box"][None]),
                                                  jnp.asarray(sample["paras"][None]), crop,
                                                  crop))[0]
        mesh = np.asarray(jax_head(np.asarray(uvd[0])[:, :2])) * 1000.0 + xyz[0]
        mesh[:, 1:] *= -1
        assert_close(saved[f"sample{i}_joints_xyz"], xyz, rtol=0,
                     atol=1e-5 * np.abs(xyz).max())
        assert_close(saved[f"sample{i}_mesh"], mesh, rtol=0,
                     atol=MESH_TOL * np.abs(mesh).max())


def test_demo_apps_default_to_the_card(monkeypatch, tmp_path):
    """Without ``--device`` the demo and ``a2j_mesh`` run on the card: where
    there is none they raise instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        demo.main(["--frames", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        a2j_mesh.main(["--synthetic", "1", "--data-dir", str(tmp_path), "--out",
                       str(tmp_path / "m.npz")])


# ---------------------------------------------------------------------------
# apps/ros_node.py

def test_ros_node_imports_without_rclpy():
    """The module imports, and builds a node over a stand-in server, with no
    ``rclpy`` (a fresh interpreter: nothing else may have loaded it)."""
    import subprocess

    code = ("import sys; import handnet_tpu_torch.apps.ros_node as r; "
            "r.HandNetRosNode(object(), print); print('rclpy' in sys.modules)")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=repo, env={**os.environ, "PYTHONPATH": repo})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "False"


_MESSAGES = st.lists(st.tuples(st.integers(0, 1), st.integers(0, 400)), max_size=40)


@settings(max_examples=60, deadline=None)
@given(_MESSAGES, st.sampled_from([0.0, 0.05, 0.1, 0.25]), st.integers(1, 3))
def test_synchronizer_matches_jax(messages, slop, queue_size):
    """The same message sequences (channel, stamp in 10 ms ticks) give the
    same pairs, fire flags and left-over queues."""
    fired = ([], [])
    syncs = [cls(lambda s, a, b, out=out: out.append((s, a, b)), slop=slop,
                 queue_size=queue_size)
             for cls, out in ((ros_node.ApproximateTimeSynchronizer, fired[0]),
                              (jros.ApproximateTimeSynchronizer, fired[1]))]
    for n, (channel, tick) in enumerate(messages):
        flags = [s.add(channel, tick / 100.0, f"m{n}") for s in syncs]
        assert flags[0] == flags[1]
    assert fired[0] == fired[1]
    assert [list(q) for q in syncs[0].queues] == [list(q) for q in syncs[1].queues]


@settings(max_examples=40, deadline=None)
@given(st.lists(st.floats(-1e4, 1e4, allow_nan=False), min_size=9, max_size=9),
       st.sampled_from(["16UC1", "32FC1", "bgr8", "mono8"]), st.integers(0, 2 ** 32 - 1))
def test_intrinsics_and_decode_match_jax(k, encoding, seed):
    got = ros_node.intrinsics_to_paras(k)
    want = jros.intrinsics_to_paras(k)
    assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)
    rng = np.random.default_rng(seed)
    data = (rng.integers(0, 65535, (5, 7)).astype(np.uint16) if encoding == "16UC1"
            else rng.uniform(0, 3, (5, 7)).astype(np.float32))
    if encoding in ("16UC1", "32FC1"):
        got, want = ros_node.decode_depth(data, encoding), jros.decode_depth(data, encoding)
        assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)
    else:
        for fn in (ros_node.decode_depth, jros.decode_depth):
            with pytest.raises(ValueError, match="Unsupported depth type"):
                fn(data, encoding)


ROS_HW = (60, 80)


def _ros_cfg():
    return pconfig.HandNetConfig(
        a2j=pconfig.A2JConfig(crop_h=48, crop_w=48, head_features=32),
        fcos=pconfig.FCOSConfig(image_h=64, image_w=96, max_detections=8, num_classes=2,
                                ext=False, score_thresh=0.0, fpn_channels=32, num_convs=2),
        pipeline=pconfig.PipelineConfig(crop_size=48))


def test_node_payloads_over_port_server():
    """Pairs of RGB and depth (16UC1 and 32FC1, stamps within the slop, and
    one depth message outside it) through a CPU port server with
    ``quantized_transfer``: each paired frame is published once with its
    stamp; a 16UC1 frame reaches the server untouched; the payload equals
    the server's direct forward of the same wire-quantized frame, and
    ``joints_xyz`` equals JAX's ``convert_joints`` of the payload's uvd and
    box."""
    from handnet_tpu_torch.apps.serve import PipelineServer

    quantized = True
    server = PipelineServer(_ros_cfg(), batch_size=2, frame_hw=ROS_HW, dtype=torch.float32,
                            device="cpu", quantized_transfer=quantized).start()
    published, submitted = [], []
    submit = server.submit
    server.submit = lambda *a: submitted.append(a) or submit(*a)
    node = ros_node.HandNetRosNode(server, lambda topic, p: published.append((topic, p)))
    node.set_camera_info([600, 0, 40, 0, 600, 30, 0, 0, 1])
    rng = np.random.default_rng(6)
    try:
        for i in range(4):
            t = 10.0 + i
            node.on_rgb(t, rng.uniform(size=ROS_HW + (3,)).astype(np.float32))
            if i % 2:
                node.on_depth(t + 0.02, rng.uniform(0.3, 1.0, ROS_HW).astype(np.float32),
                              "32FC1")
            else:
                node.on_depth(t + 0.05, rng.integers(300, 1000, ROS_HW).astype(np.uint16),
                              "16UC1")
        node.on_rgb(20.0, rng.uniform(size=ROS_HW + (3,)).astype(np.float32))
        node.on_depth(20.5, rng.uniform(0.3, 1.0, ROS_HW).astype(np.float32))  # outside
        got, deadline = 0, time.time() + 120
        while got < 4 and time.time() < deadline:
            got += node.drain(timeout=0.5)
        assert node.drain(timeout=0.2) == 0
    finally:
        server.stop()
    assert got == 4 and {t for t, _ in published} == {"hand_pose"}
    assert sorted(p["stamp"] for _, p in published) == [10.0, 11.0, 12.0, 13.0]
    by_id = {p["frame_id"]: p for _, p in published}
    assert sorted(by_id) == [0, 1, 2, 3] and [a[1] for a in submitted] == [0, 1, 2, 3]
    for _, fid, rgb, depth in submitted:
        # 16UC1 frames (even ids) pass through as uint16 on a quantized wire
        assert depth.dtype == (np.uint16 if quantized and fid % 2 == 0 else np.float32)
        if quantized:   # the wire format, as submit makes it
            rgb = np.clip(rgb * 255.0, 0, 255).astype(np.uint8)
            if depth.dtype != np.uint16:
                depth = np.clip(depth * 1000.0, 0, 65535).astype(np.uint16)
        direct = server._fwd(torch.from_numpy(np.broadcast_to(rgb, (2,) + rgb.shape).copy()),
                             torch.from_numpy(np.broadcast_to(depth, (2,) + depth.shape).copy()))
        p = by_id[fid]
        for key in ("joints_uvd", "boxes", "found", "scores"):
            assert np.array_equal(p[key], direct[key][0].numpy()), key
        want = np.asarray(jgeometry.convert_joints(p["joints_uvd"][None], p["boxes"][None],
                                                   node.paras[None], 48, 48))[0]
        assert_close(p["joints_xyz"], want, rtol=1e-6, atol=1e-3)


class _StandInServer:
    """What the node uses of a server: ``submit`` (answered at once with
    zero joints), ``get``, ``results``, ``cfg`` and ``quantized_transfer``."""

    cfg = _ros_cfg()

    def __init__(self, quantized_transfer=False):
        self.quantized_transfer = quantized_transfer
        self.results = queue.Queue()
        self.submitted = []

    def submit(self, sid, fid, rgb, depth):
        self.submitted.append((sid, fid, rgb, depth))
        self.results.put((sid, fid, {"joints_uvd": np.zeros((21, 3), np.float32),
                                     "boxes": np.zeros(4, np.float32)}))

    def get(self, timeout=None):
        return self.results.get(timeout=timeout)


@pytest.mark.parametrize("quantized", [True, False])
def test_node_depth_encodings(quantized):
    """16UC1 passes through untouched (uint16 mm) on a quantized wire and
    is decoded to float32 metres otherwise, as JAX's node does; 32FC1
    passes as float32; an unsupported encoding is dropped."""
    got, want = _StandInServer(quantized), _StandInServer(quantized)
    mm = np.random.default_rng(9).integers(300, 1000, (4, 5)).astype(np.uint16)
    for node in (ros_node.HandNetRosNode(got, lambda t, p: None),
                 jros.HandNetRosNode(want, lambda t, p: None)):
        node.on_rgb(1.0, np.zeros((4, 5, 3), np.float32))
        node.on_depth(1.01, mm, "16UC1")
        node.on_rgb(2.0, np.zeros((4, 5, 3), np.float32))
        node.on_depth(2.01, mm.astype(np.float32) / 1000.0, "32FC1")
        node.on_rgb(3.0, np.zeros((4, 5, 3), np.float32))
        node.on_depth(3.01, mm, "bgr8")
    assert len(got.submitted) == len(want.submitted) == 2
    for (_, gf, _, gd), (_, wf, _, wd) in zip(got.submitted, want.submitted):
        assert gf == wf and gd.dtype == wd.dtype and np.array_equal(gd, wd)
    assert got.submitted[0][3].dtype == (np.uint16 if quantized else np.float32)


def test_node_puts_back_foreign_results():
    """Results of another stream on a shared server go back on its queue,
    once per pass, and this node publishes only its own."""

    server = _StandInServer()
    for fid in range(2):
        server.results.put(("other", fid, {"joints_uvd": np.ones((21, 3), np.float32)}))
    published = []
    node = ros_node.HandNetRosNode(server, lambda t, p: published.append(p))
    node.on_rgb(1.0, np.zeros((4, 4, 3), np.float32))
    node.on_depth(1.01, np.zeros((4, 4), np.float32))
    assert node.drain(timeout=0.1) == 1
    assert [p["frame_id"] for p in published] == [0] and published[0]["stamp"] == 1.0
    left = [server.results.get_nowait() for _ in range(server.results.qsize())]
    assert [(s, f) for s, f, _ in left] == [("other", 0), ("other", 1)]
