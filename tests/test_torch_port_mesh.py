"""The mesh head: ``handnet_tpu_torch`` ``ops/graph.py``,
``models/pose2mesh.py``, ``ops/rotation.py``, ``models/mano.py`` and the
``pipeline.with_mesh`` forward (live, served and exported) against their
``handnet_tpu`` counterparts.

Weights start from the port's seeded init, get random norm statistics and
reach the JAX side through the JAX package's converters (``convert_fcos``,
``convert_a2j``, ``convert_pose2mesh``). Inputs are numpy-seeded, both sides
run in float32 on the CPU, and every JAX apply is jitted. The pipeline runs
at ``tests/test_pipeline_modes.py``'s shapes (64x96 detector, 48^2 crops)
with 64-wide FPN and A2J heads and a 64-wide PoseNet; the GCN keeps its
fixed channel plan on the strip stand-in's full 6-level pyramid (1152
nodes at level 0).
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from handnet_tpu import config as jconfig
from handnet_tpu.convert.torch_weights import convert_a2j, convert_fcos, convert_pose2mesh
from handnet_tpu.models import mano as jmano
from handnet_tpu.models import pose2mesh as jp2m
from handnet_tpu.models.pipeline import HandNetPipeline as JaxPipeline
from handnet_tpu.nn import quant as jquant
from handnet_tpu.ops import graph as jgraph
from handnet_tpu.ops import rotation as jrot
from handnet_tpu_torch import config as pconfig
from handnet_tpu_torch.apps.serve import PipelineServer
from handnet_tpu_torch.convert.from_flax import (flax_calibration_key,
                                                 pipeline_state_dict_from_flax,
                                                 pose2mesh_state_dict_from_flax)
from handnet_tpu_torch.export import MANIFEST_NAME, ServingArtifact, export_pipeline
from handnet_tpu_torch.models import mano as pmano
from handnet_tpu_torch.models import pose2mesh as pp2m
from handnet_tpu_torch.models.pipeline import HandNetPipeline
from handnet_tpu_torch.nn import quant as pquant
from handnet_tpu_torch.ops import graph as pgraph
from handnet_tpu_torch.ops import rotation as prot
from torch_port_fixtures import assert_close, leaves_equal, randomize_norms

REPO = Path(__file__).resolve().parent.parent
H, W, CROP, WIDTH, HID = 64, 96, 48, 64, 64
SKELETON = ((0, 1), (0, 5), (0, 9), (0, 13), (0, 17), (1, 2), (2, 3), (3, 4),
            (5, 6), (6, 7), (7, 8), (9, 10), (10, 11), (11, 12), (13, 14),
            (14, 15), (15, 16), (17, 18), (18, 19), (19, 20))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small forwards: one intra-op thread keeps them from crowding the
    other test processes, some of which time their own runs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def random_mesh(rng, n_verts=80, n_faces=200):
    """``tests/test_pose2mesh.py:24``'s random mesh."""
    faces = rng.integers(0, n_verts, size=(n_faces, 3))
    faces[:, 1] = (faces[:, 0] + 1) % n_verts
    faces[:, 2] = (faces[:, 0] + 2) % n_verts
    faces[:n_verts, 0] = np.arange(n_verts)
    faces[:n_verts, 1] = (np.arange(n_verts) + 1) % n_verts
    faces[:n_verts, 2] = (np.arange(n_verts) + 2) % n_verts
    return faces


MESHES = {"random80": lambda: random_mesh(np.random.default_rng(0)),
          "strip778": lambda: np.stack([np.arange(776), np.arange(1, 777),
                                        np.arange(2, 778)], axis=1)}


def _sparse_equal(a, b) -> bool:
    return a.shape == b.shape and (sp.csr_matrix(a) != sp.csr_matrix(b)).nnz == 0


# ---------------------------------------------------------------------------
# ops/graph.py

@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_graph_pyramid_matches_jax(mesh):
    """Laplacians within 1e-5 (each side's ARPACK lmax converges to ~1e-6;
    JAX's random start moves it by that much from build to build);
    perm, perm_reverse and mesh_sizes exact. The strip stand-in gives the
    pyramid the pipeline's head runs on: 1152, 576, 288, 144, 72, 36, 21."""
    faces = MESHES[mesh]()
    got = pgraph.build_graph_pyramid(faces, 21, SKELETON, levels=6)
    want = jgraph.build_graph_pyramid(faces, 21, SKELETON, levels=6)
    assert got.mesh_sizes == want.mesh_sizes
    if mesh == "strip778":
        assert got.mesh_sizes == (1152, 576, 288, 144, 72, 36, 21)
    for field in ("perm", "perm_reverse"):
        assert np.array_equal(getattr(got, field), getattr(want, field)), field
    for g, w in zip(got.laplacians, want.laplacians):
        assert g.dtype == np.float32 and g.shape == w.shape
        assert_close(g, w, rtol=0, atol=1e-5)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_graph_helpers_match_jax(mesh):
    """Every step of the build, exactly: adjacency, the normalized
    Laplacian, HEM coarsening's graphs and parents (window and diagonal
    quirks), the binary-tree permutations, the permuted adjacency, the
    reverse index, the joint graph and the rescale at a given lmax."""
    faces = MESHES[mesh]()
    n = int(faces.max()) + 1
    adj = pgraph.mesh_adjacency(faces, n)
    assert _sparse_equal(adj, jgraph.mesh_adjacency(faces, n))
    assert _sparse_equal(pgraph.normalized_laplacian(adj), jgraph.normalized_laplacian(adj))
    graphs, parents = pgraph.hem_coarsen(adj, 4)
    jgraphs, jparents = jgraph.hem_coarsen(adj, 4)
    assert all(np.array_equal(p, q) for p, q in zip(parents, jparents))
    assert all(_sparse_equal(g, q) for g, q in zip(graphs, jgraphs))
    perms = pgraph.binary_tree_perms(parents)
    assert all(np.array_equal(p, q) for p, q in zip(perms, jgraph.binary_tree_perms(parents)))
    assert _sparse_equal(pgraph.permute_adjacency(graphs[1], perms[1]),
                         jgraph.permute_adjacency(graphs[1], perms[1]))
    assert np.array_equal(pgraph.perm_index_reverse(perms[0]),
                          jgraph.perm_index_reverse(perms[0]))
    assert np.array_equal(pgraph.joint_adjacency(21, SKELETON, ((4, 8),)),
                          jgraph.joint_adjacency(21, SKELETON, ((4, 8),)))
    lap = pgraph.normalized_laplacian(adj)
    assert abs(pgraph.lmax(lap) - jgraph.lmax(lap)) <= 1e-5
    assert _sparse_equal(pgraph.rescale_laplacian(lap, 1.7), jgraph.rescale_laplacian(lap, 1.7))


def test_pyramid_build_is_deterministic_and_skeleton_is_the_pipelines():
    """The port starts ARPACK from a fixed vector, so two builds give the
    same bits (an artifact and its pipeline then agree exactly); the strip
    faces and the hand skeleton are those of the JAX pipeline's head."""
    faces = pgraph.strip_faces()
    assert np.array_equal(faces, MESHES["strip778"]())
    assert sorted(pgraph.HAND_SKELETON) == sorted(SKELETON)
    a = pgraph.build_graph_pyramid(faces, 21, pgraph.HAND_SKELETON)
    b = pgraph.build_graph_pyramid(faces, 21, pgraph.HAND_SKELETON)
    assert all(np.array_equal(x, y) for x, y in zip(a.laplacians, b.laplacians))


# ---------------------------------------------------------------------------
# models/pose2mesh.py

@pytest.fixture(scope="module")
def small_pyramid():
    """The 80-vertex random mesh's pyramid, for both sides (the module tests
    isolate the modules from the pyramid's build)."""
    pyr = pgraph.build_graph_pyramid(MESHES["random80"](), 21, SKELETON, levels=6)
    return pyr, jgraph.GraphPyramid(laplacians=pyr.laplacians, perm=pyr.perm,
                                    perm_reverse=pyr.perm_reverse, mesh_sizes=pyr.mesh_sizes)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_cheby_conv_matches_jax(k):
    """Dense Chebyshev recurrence and the reference's Fin-major, k-minor
    flattening, within 1e-5. The port is vertex-major ([V, B, F]) and takes
    the torch Linear layout [Fout, Fin*K] (the flax kernel transposed)."""
    rng = np.random.default_rng(k)
    x = rng.normal(size=(2, 30, 8)).astype(np.float32)
    lap = rng.normal(size=(30, 30)).astype(np.float32) * 0.2
    weight = rng.normal(size=(8 * k, 5)).astype(np.float32)
    bias = rng.normal(size=(5,)).astype(np.float32)
    want = jax.jit(jp2m.cheby_conv, static_argnums=4)(x, lap, weight, bias, k)
    got = pp2m.cheby_conv(torch.from_numpy(x).transpose(0, 1).contiguous(),
                          torch.from_numpy(lap), torch.from_numpy(weight.T.copy()),
                          torch.from_numpy(bias), k)
    assert_close(got.transpose(0, 1).numpy(), want, rtol=1e-5, atol=1e-5)


def test_cheby_layer_matches_jax():
    """JAX's ChebyLayer (conv + BN over (B*V, F)) against the port's
    ``cl.N`` followed by ``bn.N``, with random BN statistics, within 1e-5."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 24, 16)).astype(np.float32)
    lap = rng.normal(size=(24, 24)).astype(np.float32) * 0.2
    layer, bn = pp2m.ChebyLayer(16, 32, 3), pp2m.FrozenBatchNorm1d(32)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(rng.normal(size=(32, 48)).astype(np.float32)))
        layer.bias.copy_(torch.from_numpy(rng.normal(size=(32,)).astype(np.float32)))
        for name, lo, hi in (("weight", 0.5, 1.5), ("bias", -0.1, 0.1),
                             ("running_mean", -0.1, 0.1), ("running_var", 0.5, 1.5)):
            getattr(bn, name).copy_(torch.from_numpy(rng.uniform(lo, hi, 32).astype(np.float32)))
    variables = {"params": {"kernel": layer.weight.detach().numpy().T, "bias": layer.bias.detach().numpy(),
                            "bn": {"scale": bn.weight.detach().numpy(),
                                   "bias": bn.bias.detach().numpy()}},
                 "batch_stats": {"bn": {"mean": bn.running_mean.numpy(),
                                        "var": bn.running_var.numpy()}}}
    want = jax.jit(lambda v, a, l: jp2m.ChebyLayer(32, 3).apply(v, a, l))(variables, x, lap)
    with torch.no_grad():
        got = bn(layer(torch.from_numpy(x).transpose(0, 1).contiguous(), torch.from_numpy(lap)))
    assert_close(got.transpose(0, 1).numpy(), want, rtol=1e-5, atol=1e-5)


def test_feature_resize_matrix_is_the_jax_packages():
    for fin, fout in ((64, 256), (256, 128), (256, 256), (5, 3)):
        assert np.array_equal(pp2m._feature_resize_matrix(fin, fout),
                              jp2m._feature_resize_matrix(fin, fout))


@pytest.fixture(scope="module")
def p2m_weights(small_pyramid):
    """A port Pose2Mesh (PoseNet 64 wide) with random norms, and its flax
    variables through ``convert_pose2mesh``."""
    pyr, _ = small_pyramid
    model = pp2m.Pose2Mesh(pyr, pconfig.Pose2MeshConfig(posenet_hid=HID))
    model.init_weights_(torch.Generator().manual_seed(7))
    flax_vars = randomize_norms(convert_pose2mesh(
        {k: v.numpy() for k, v in model.state_dict().items()}), seed=8)
    model.load_state_dict(pose2mesh_state_dict_from_flax(flax_vars), strict=True)
    return model, flax_vars


def test_pose2mesh_state_dict_round_trip(p2m_weights):
    """``convert_pose2mesh`` reads the port's state dict (the reference's
    names; the unused ``pose_lifter.batch_norm1`` is not declared), and
    ``pose2mesh_state_dict_from_flax`` maps the tree back, leaf for leaf."""
    model, flax_vars = p2m_weights
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    assert "pose_lifter.linear_stages.1.batch_norm2.running_var" in sd
    assert "pose2mesh.cl.14.weight" in sd and "pose2mesh.bn.13.weight" in sd
    assert "pose2mesh.bn.14.weight" not in sd
    assert leaves_equal(convert_pose2mesh(sd), flax_vars)
    back = pose2mesh_state_dict_from_flax(flax_vars)
    assert sorted(back) == sorted(sd)
    assert all(np.array_equal(back[k].numpy(), sd[k]) for k in sd)


def test_posenet_matches_jax(p2m_weights):
    """The lifter (64 wide, 2 residual stages, random BN) within 1e-5."""
    model, flax_vars = p2m_weights
    pose2d = np.random.default_rng(9).normal(size=(3, 21, 2)).astype(np.float32)
    lifter = jp2m.PoseNet(hid=HID, stages=2)
    want = jax.jit(lifter.apply)({c: flax_vars[c]["pose_lifter"] for c in flax_vars}, pose2d)
    with torch.no_grad():
        got = model.pose_lifter(torch.from_numpy(pose2d))
    assert_close(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_meshnet_and_pose2mesh_match_jax(p2m_weights, small_pyramid):
    """MeshNet alone and the whole Pose2Mesh on the 80-vertex random mesh
    (the del laps[-2] walk, the fc, the residual resizes, the
    repeat_interleave upsample), within 1e-4 of the output's scale."""
    model, flax_vars = p2m_weights
    _, jpyr = small_pyramid
    rng = np.random.default_rng(10)
    pose2d = rng.normal(size=(3, 21, 2)).astype(np.float32)
    combined = rng.normal(size=(3, 21, 5)).astype(np.float32)
    jmodel = jp2m.Pose2Mesh(pyramid=jpyr, cfg=jconfig.Pose2MeshConfig(posenet_hid=HID))
    want_mesh, want_pose3d = jax.jit(jmodel.apply)(flax_vars, pose2d)
    meshnet = jp2m.MeshNet(jpyr)
    want_gcn = jax.jit(meshnet.apply)({c: flax_vars[c]["pose2mesh"] for c in flax_vars},
                                      combined)
    with torch.no_grad():
        got_mesh, got_pose3d = model(torch.from_numpy(pose2d))
        got_gcn = model.pose2mesh(torch.from_numpy(combined)).transpose(0, 1)
    assert got_mesh.shape == want_mesh.shape == (3, jpyr.mesh_sizes[0], 3)
    assert_close(got_pose3d.numpy(), want_pose3d, rtol=1e-5, atol=1e-5)
    for got, want in ((got_mesh, want_mesh), (got_gcn, want_gcn)):
        scale = float(np.abs(np.asarray(want)).max())
        assert_close(got.numpy(), want, rtol=0, atol=1e-4 * scale)


def test_normalize_matches_jax_and_host():
    """The batched on-device normalization against JAX's and against the
    host helper (population std), and all-zero (masked) rows give zeros,
    not NaN."""
    rng = np.random.default_rng(11)
    joints = rng.uniform(10, 150, size=(4, 21, 2)).astype(np.float32)
    joints[1, :, 1] = joints[1, :, 0] * 0.3 + 40.0   # a box wider than its aspect
    joints[3] = 0.0                                   # a masked frame
    got = pp2m.normalize_joints_for_pose2mesh_batched(torch.from_numpy(joints)).numpy()
    want = np.asarray(jax.jit(jp2m.normalize_joints_for_pose2mesh_batched)(joints))
    assert_close(got, want, rtol=1e-5, atol=1e-5)
    for b in range(3):
        assert_close(got[b], pp2m.normalize_joints_for_pose2mesh(joints[b]), rtol=0, atol=1e-4)
        assert np.array_equal(pp2m.normalize_joints_for_pose2mesh(joints[b]),
                              jp2m.normalize_joints_for_pose2mesh(joints[b]))
    assert np.isfinite(got).all() and not got[3].any()


# ---------------------------------------------------------------------------
# the pipeline with the mesh head

def _cfg(module, quant=False, score_thresh=0.0, with_mesh=True):
    return module.HandNetConfig(
        a2j=module.A2JConfig(crop_h=CROP, crop_w=CROP, head_features=WIDTH, quant=quant),
        fcos=module.FCOSConfig(image_h=H, image_w=W, max_detections=8, num_classes=3,
                               ext=False, score_thresh=score_thresh, fpn_channels=WIDTH,
                               quant=quant),
        pipeline=module.PipelineConfig(crop_size=CROP, with_mesh=with_mesh),
        pose2mesh=module.Pose2MeshConfig(posenet_hid=HID))


def _frames(seed, batch=2):
    rng = np.random.default_rng(seed)
    images = rng.uniform(size=(batch, H, W, 3)).astype(np.float32)
    depth = rng.uniform(0.3, 1.0, size=(batch, H, W)).astype(np.float32)
    paras = np.tile([600.0, 600.0, W / 2, H / 2], (batch, 1)).astype(np.float32)
    return images, depth, paras


@pytest.fixture(scope="module")
def weights():
    """Port state dict of the static-int8 mesh pipeline (act_amax zero) and
    the same weights as JAX variables, the head's included."""
    sd = {k: v.numpy() for k, v in HandNetPipeline(_cfg(pconfig, "static"), seed=0,
                                                   device="cpu").state_dict().items()}

    def part(prefix):
        return {k[len(prefix):]: v for k, v in sd.items()
                if k.startswith(prefix) and not k.endswith(".act_amax")}

    flax_vars = {"detector": randomize_norms(convert_fcos(part("detector.")), seed=4),
                 "a2j": randomize_norms(convert_a2j(part("a2j.")), seed=5),
                 "pose2mesh": randomize_norms(convert_pose2mesh(part("pose2mesh.")), seed=6)}
    return pipeline_state_dict_from_flax(flax_vars), flax_vars, sorted(
        k for k in sd if k.endswith(".act_amax"))


def _port(weights, quant=False, score_thresh=0.0):
    pipe = HandNetPipeline(_cfg(pconfig, quant, score_thresh), device="cpu")
    state = dict(weights[0])
    if quant:
        state.update({k: torch.zeros(()) for k in weights[2]})
    pipe.load_state_dict(state, strict=True)
    return pipe


def _assert_mesh_outputs(got, want, joint_tol):
    """found, sides, boxes and crops exact; joints to ``joint_tol`` px (10x
    in mm); verts to 1e-4 of their scale; verts_xyz to 1e-2 mm plus 1000x
    the verts' tolerance (the wrist's XYZ anchors them); the vertices of a
    frame without a hand zero on both sides."""
    assert sorted(got) == sorted(want) == sorted(pconfig.pipeline_outputs(
        _cfg(pconfig), with_xyz=True))
    assert want["found"].any()
    for key in ("found", "boxes", "crops"):
        assert np.array_equal(got[key], want[key]), key
    for key in ("joints_uvd", "joints_uvd_full"):
        assert_close(got[key], want[key], rtol=0, atol=joint_tol, err_msg=key)
    assert_close(got["joints_xyz"], want["joints_xyz"], rtol=0, atol=10 * joint_tol)
    assert got["verts"].shape == got["verts_xyz"].shape == (2, 778, 3)
    verts_tol = 1e-4 * float(np.abs(want["verts"]).max())
    assert_close(got["verts"], want["verts"], rtol=0, atol=verts_tol)
    assert_close(got["verts_xyz"], want["verts_xyz"], rtol=0, atol=1e-2 + 1000 * verts_tol)
    lost = ~want["found"]
    assert not got["verts"][lost].any() and not want["verts"][lost].any()
    assert np.array_equal(got["sides"][~lost], want["sides"][~lost])


def test_mesh_pipeline_matches_jax(weights):
    """Float, found path (score threshold 0): every output against JAX's
    ``HandNetPipeline.__call__`` with ``pipeline.with_mesh``."""
    frames = _frames(0)
    got = {k: v.numpy() for k, v in _port(weights)(*map(torch.from_numpy, frames)).items()}
    jax_pipe = JaxPipeline(_cfg(jconfig))
    want = jax.jit(lambda v, im, d, p: jax_pipe(v, im, d, p))(
        jax.tree_util.tree_map(jnp.asarray, weights[1]), *map(jnp.asarray, frames))
    _assert_mesh_outputs(got, {k: np.asarray(v) for k, v in want.items()}, joint_tol=1e-3)


def test_mesh_pipeline_static_int8_matches_jax(weights, tmp_path):
    """Calibrated static int8 (the head stays float and calibration leaves
    it alone), both sides with the port's calibration through the npz map.
    The detector and A2J are ``test_torch_port_quant_slice.py``'s (same
    seeds, widths, calibration and test frames), held at its tolerances;
    there, as it explains, other frames can move an int8 box by a pixel."""
    port = _port(weights, "static")
    images, depth, _ = _frames(0)
    head_before = {k: v.clone() for k, v in port.pose2mesh.state_dict().items()}
    port.calibrate(torch.from_numpy(images), torch.from_numpy(depth))
    pquant.assert_calibrated(port)
    assert all(torch.equal(v, port.pose2mesh.state_dict()[k]) for k, v in head_before.items())
    path = str(tmp_path / "cal.npz")
    pquant.save_calibration(path, port)
    tree = jax.tree_util.tree_map(np.asarray, weights[1])
    for name in weights[2]:
        model, _, *keys, leaf = flax_calibration_key(name).split("/")
        node = tree[model].setdefault("quant_stats", {})
        for part in keys:
            node = node.setdefault(part, {})
        node[leaf] = np.float32(0.0)
    jax_vars = jquant.load_calibration(path, jax.tree_util.tree_map(jnp.asarray, tree))
    frames = _frames(3)
    got = {k: v.numpy() for k, v in port(*map(torch.from_numpy, frames)).items()}
    jax_pipe = JaxPipeline(_cfg(jconfig, "static"))
    want = jax.jit(lambda v, im, d, p: jax_pipe(v, im, d, p))(jax_vars, *map(jnp.asarray, frames))
    _assert_mesh_outputs(got, {k: np.asarray(v) for k, v in want.items()}, joint_tol=1e-3)


def test_mesh_pipeline_masks_frames_without_a_hand(weights):
    """At the default 0.7 threshold random weights find no hand: verts and
    verts_xyz are zeros, not NaN (the normalization's eps guards), and the
    keys are those ``config.pipeline_outputs`` lists."""
    pipe = _port(weights, score_thresh=0.7)
    images, depth, paras = map(torch.from_numpy, _frames(3))
    out = pipe(images, depth, paras)
    assert not out["found"].any()
    assert not out["verts"].any() and not out["verts_xyz"].any()
    assert tuple(out) == pconfig.pipeline_outputs(pipe.cfg, with_xyz=True)
    assert tuple(pipe(images, depth)) == pconfig.pipeline_outputs(pipe.cfg)


def test_mesh_head_in_bf16_follows_float(weights):
    """In bfloat16 (the linears, the Chebyshev products and the resizes in
    bf16, the BN statistics float32) the head stays finite and within 5% of
    its float32 output's scale on the same frames."""
    state = weights[0]
    f32 = _port(weights)
    bf16 = HandNetPipeline(_cfg(pconfig), dtype=torch.bfloat16, device="cpu")
    bf16.load_state_dict(state, strict=True)
    assert bf16.pose2mesh.pose2mesh.lap0.dtype == torch.bfloat16
    assert bf16.pose2mesh.pose2mesh.bn[0].running_var.dtype == torch.float32
    frames = tuple(map(torch.from_numpy, _frames(0)[:2]))
    with torch.inference_mode():
        norm = pp2m.normalize_joints_for_pose2mesh_batched(f32(*frames)["joints_uvd"][..., :2])
        want, got = f32.pose2mesh(norm)[0], bf16.pose2mesh(norm)[0]
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    scale = float(want.abs().max())
    assert float((got.float() - want).abs().max()) <= 5e-2 * scale


# ---------------------------------------------------------------------------
# serving and the artifact

SERVE_HW = (60, 80)


def test_server_streams_verts_and_refuses_what_is_not_produced(weights):
    """``PipelineServer(out_fields=(..., "verts"))`` serves the mesh, equal
    to its direct forward on the CPU; a field the pipeline does not produce
    is refused at construction (``verts`` without the head, any ``*_xyz``:
    the server passes no intrinsics)."""
    server = PipelineServer(_cfg(pconfig), batch_size=2, state_dict=weights[0],
                            frame_hw=SERVE_HW, dtype=torch.float32, device="cpu",
                            out_fields=("joints_uvd", "found", "verts"), flush_timeout=0.001)
    rng = np.random.default_rng(12)
    rgb = rng.integers(0, 256, size=(2, *SERVE_HW, 3), dtype=np.uint8)
    depth = rng.integers(300, 1000, size=(2, *SERVE_HW), dtype=np.uint16)
    direct = server._fwd(torch.from_numpy(rgb), torch.from_numpy(depth))
    server.start()
    try:
        for i in range(2):
            server.submit("s", i, rgb[i], depth[i])
        served = {}
        for _ in range(2):
            _, fid, out = server.get(timeout=60)
            assert sorted(out) == ["found", "joints_uvd", "verts"]
            served[fid] = out
    finally:
        server.stop()
    assert direct["verts"].shape == (2, 778, 3) and direct["found"].all()
    for i in range(2):
        for key, value in served[i].items():
            assert np.array_equal(value, direct[key][i].numpy()), key
    for cfg, fields in ((_cfg(pconfig, with_mesh=False), ("joints_uvd", "verts")),
                        (_cfg(pconfig), ("verts", "verts_xyz")),
                        (_cfg(pconfig), ("joints_xyz",))):
        with pytest.raises(ValueError, match="does not emit"):
            PipelineServer(cfg, batch_size=2, out_fields=fields, device="cpu")


@pytest.fixture(scope="module")
def mesh_artifact(weights, tmp_path_factory):
    """One float with_mesh artifact (bucket 2, quantized wire, with_xyz),
    exported and loaded once; the live pipeline it came from."""
    pipe = _port(weights)
    out = str(tmp_path_factory.mktemp("aot") / "mesh")
    export_pipeline(pipe.cfg, pipe.state_dict(), out, buckets=(2,), frame_hw=SERVE_HW,
                    dtype=torch.float32, with_xyz=True, quantized_wire=True, device="cpu")
    return ServingArtifact.load(out), pipe, out


def _wire_frames(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, size=(n, *SERVE_HW, 3), dtype=np.uint8),
            rng.integers(300, 1000, size=(n, *SERVE_HW), dtype=np.uint16),
            np.tile([600.0, 600.0, 40.0, 30.0], (n, 1)).astype(np.float32))


def _live(pipe, rgb, depth, paras):
    """The live pipeline on frames padded (zeros, paras with ones) to 2."""
    from handnet_tpu_torch.graphs import dequantize_wire

    n = len(rgb)
    pad = [(0, 2 - n)]
    args = dequantize_wire(torch.from_numpy(np.pad(rgb, pad + [(0, 0)] * 3)),
                           torch.from_numpy(np.pad(depth, pad + [(0, 0)] * 2)))
    out = pipe(*args, torch.from_numpy(np.pad(paras, pad + [(0, 0)], constant_values=1.0)))
    return {k: v[:n].numpy() for k, v in out.items()}


@pytest.mark.parametrize("n", [2, 1], ids=["full", "padded"])
def test_mesh_artifact_matches_live_pipeline(mesh_artifact, n):
    """The artifact's every output, verts and verts_xyz included, equals
    the live pipeline's bit for bit, on a full and on a padded bucket; the
    manifest records the head."""
    art, pipe, out = mesh_artifact
    rgb, depth, paras = _wire_frames(n, 13)
    got = art.predict(rgb, depth, paras)
    want = _live(pipe, rgb, depth, paras)
    assert sorted(got) == sorted(want) and "verts_xyz" in got
    for key in want:
        assert np.array_equal(got[key], want[key]), key
    with open(os.path.join(out, MANIFEST_NAME)) as f:
        manifest = json.load(f)
    assert manifest["with_mesh"] is True and art.with_mesh
    assert manifest["config"]["pipeline"]["with_mesh"] is True


_FRESH_SCRIPT = """
import sys
import numpy as np
from handnet_tpu_torch.export import ServingArtifact

path, frames_path = sys.argv[1], sys.argv[2]
frames = np.load(frames_path)
art = ServingArtifact.load(path)
np.savez(path + "/fresh.npz", **art.predict(frames["rgb"], frames["depth"], frames["paras"]))
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "handnet_tpu")
                or m.startswith("handnet_tpu_torch.models"))
print("LOADED", loaded)
"""


def test_mesh_artifact_in_a_fresh_interpreter(mesh_artifact, tmp_path):
    """A fresh interpreter loads the with_mesh artifact and predicts with
    neither jax, the JAX package nor ``handnet_tpu_torch.models`` loaded
    (the pyramid's buffers are constants of the program); its verts equal
    the live pipeline's."""
    _, pipe, out = mesh_artifact
    rgb, depth, paras = _wire_frames(2, 14)
    np.savez(tmp_path / "frames.npz", rgb=rgb, depth=depth, paras=paras)
    # one intra-op thread, as here: the CPU convolutions' bits depend on it
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-c", _FRESH_SCRIPT, out, str(tmp_path / "frames.npz")],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().splitlines()[-1] == "LOADED []", proc.stdout
    want = _live(pipe, rgb, depth, paras)
    with np.load(os.path.join(out, "fresh.npz")) as data:
        assert sorted(data.files) == sorted(want)
        for key in want:
            assert np.array_equal(data[key], want[key]), key


# ---------------------------------------------------------------------------
# ops/rotation.py and models/mano.py

@pytest.mark.parametrize("fn,width", [("quat_to_rotmat", 4), ("batch_rodrigues", 3),
                                      ("rot6d_to_rotmat", 6)])
def test_rotation_matches_jax(fn, width):
    """Within 1e-6 on random inputs (tiny angles included: the +1e-8 inside
    Rodrigues' norm)."""
    x = np.random.default_rng(15).normal(size=(4, 5, width)).astype(np.float32)
    x[0, 0] *= 1e-9
    want = jax.jit(getattr(jrot, fn))(x)
    got = getattr(prot, fn)(torch.from_numpy(x))
    assert got.shape == want.shape == (4, 5, 3, 3)
    assert_close(got.numpy(), want, rtol=1e-6, atol=1e-6)


MANO_CASES = {
    "default": ({}, "right", True, True),
    "center_flat": ({"center_idx": 9, "flat_hand_mean": True}, "right", True, False),
    "no_pca_left": ({"use_pca": False}, "left", False, False),
    "ncomps12": ({"ncomps": 12}, "right", True, True),
}


@pytest.mark.parametrize("case", sorted(MANO_CASES))
def test_mano_layer_matches_jax(case):
    """``ManoLayer`` against JAX's on ``ManoAssets.synthetic`` (the same
    draws on both sides), verts and joints in mm within 1e-5 of their
    scale: PCA or not, hands_mean or flat, betas or none, trans or a
    center joint, right and left tips."""
    kw, side, with_betas, with_trans = MANO_CASES[case]
    assets_j = jmano.ManoAssets.synthetic(np.random.default_rng(16), side=side)
    assets_p = pmano.ManoAssets.synthetic(np.random.default_rng(16), side=side)
    assets_j = dataclasses.replace(assets_j, hands_mean=np.linspace(-0.2, 0.2, 45, dtype=np.float32))
    assets_p = dataclasses.replace(assets_p, hands_mean=assets_j.hands_mean)
    rng = np.random.default_rng(17)
    ncomps = kw.get("ncomps", 45)
    args = (rng.normal(size=(3, 3 + ncomps)).astype(np.float32) * 0.5,
            rng.normal(size=(3, 10)).astype(np.float32) if with_betas else None,
            rng.normal(size=(3, 3)).astype(np.float32) if with_trans else None)
    want = jmano.ManoLayer(assets_j, **kw)(*(None if a is None else jnp.asarray(a) for a in args))
    got = pmano.ManoLayer(assets_p, device="cpu", **kw)(
        *(None if a is None else torch.from_numpy(a) for a in args))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert_close(g.numpy(), w, rtol=0, atol=1e-5 * float(np.abs(np.asarray(w)).max()))


def test_mano_assets_load_and_device(tmp_path, monkeypatch):
    """``ManoAssets.load`` reads the converter's npz as JAX's does, the
    synthetic assets draw the same numbers, and the layer defaults to the
    card (raising where there is none) with its tensors as buffers."""
    assets = jmano.ManoAssets.synthetic(np.random.default_rng(18))
    path = tmp_path / "mano.npz"
    np.savez(path, **{f.name: getattr(assets, f.name) for f in dataclasses.fields(assets)
                      if f.name != "side"})
    got, want = pmano.ManoAssets.load(str(path), side="left"), jmano.ManoAssets.load(str(path), side="left")
    synthetic = pmano.ManoAssets.synthetic(np.random.default_rng(18))
    for f in dataclasses.fields(want):
        assert np.array_equal(getattr(got, f.name), getattr(want, f.name)), f.name
        assert np.array_equal(getattr(synthetic, f.name), getattr(assets, f.name)), f.name
    layer = pmano.ManoLayer(got, device="cpu")
    assert layer.state_dict() == {} and layer.v_template.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmano.ManoLayer(got)
