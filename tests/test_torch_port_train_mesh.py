"""The port's Pose2Mesh training path (``train/pose2mesh_loss.py``,
``apps/train_pose2mesh.py``) against the JAX package's, on the CPU.

The JAX side of the train step is the JAX app's composition
(``Pose2Mesh.apply(train=False)``, the mesh in vertex order,
``pose2mesh_losses(faces=)``, ``optax.adam``), jitted, on variables that
come from the port's seeded init through ``convert_pose2mesh``. Inputs come
from numpy seeds; everything runs on one torch thread.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from handnet_tpu import config as jconfig
from handnet_tpu.apps import train_pose2mesh as japp
from handnet_tpu.convert.torch_weights import convert_pose2mesh
from handnet_tpu.models import mano as jmano
from handnet_tpu.models import pose2mesh as jp2m
from handnet_tpu.ops import graph as jgraph
from handnet_tpu.train import checkpoints as jckpt
from handnet_tpu.train import pose2mesh_loss as jloss
from handnet_tpu_torch import config as pconfig
from handnet_tpu_torch.apps import train_pose2mesh as papp
from handnet_tpu_torch.convert.from_flax import (pose2mesh_state_dict_from_flax,
                                                 pose2mesh_variables_from_state_dict)
from handnet_tpu_torch.train import pose2mesh_loss as ploss
from torch_port_fixtures import assert_close, leaves_equal


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small forwards: one intra-op thread keeps them from crowding the
    other test processes, some of which time their own runs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v, np.float64)


STRIP = np.stack([np.arange(776), np.arange(1, 777), np.arange(2, 778)], 1)


def random_mesh(rng, n_verts=80, n_faces=200):
    """``tests/test_pose2mesh.py:24``'s random mesh."""
    faces = rng.integers(0, n_verts, size=(n_faces, 3))
    faces[:, 1] = (faces[:, 0] + 1) % n_verts
    faces[:, 2] = (faces[:, 0] + 2) % n_verts
    faces[:n_verts, 0] = np.arange(n_verts)
    faces[:n_verts, 1] = (np.arange(n_verts) + 1) % n_verts
    faces[:n_verts, 2] = (np.arange(n_verts) + 2) % n_verts
    return faces


def test_app_constants_are_the_jax_apps():
    """The skeleton, the ``HORI`` pairs and the strip faces are the JAX
    app's (its joint graph has the ``HORI`` edges; the serving pipeline's
    has not)."""
    assert papp.HAND_SKELETON == japp.SKELETON and papp.HORI == japp.HORI
    assert np.array_equal(papp.training_faces(papp.ManoAssets.synthetic(
        np.random.default_rng(0))), STRIP)


# ---------------------------------------------------------------------------
# the losses


def _meshes(seed, b=3, v=778):
    rng = np.random.default_rng(seed)
    gt = rng.normal(size=(b, v, 3)).astype(np.float32) * 50
    pred = gt + rng.normal(size=(b, v, 3)).astype(np.float32) * 5
    return pred, gt


def test_pose2mesh_losses_match_jax():
    """Every term of ``pose2mesh_losses`` (with the joints-from-mesh term
    and with the strip faces' normal and edge terms) against JAX's, to 1e-6
    relative; ``uniform_laplacian`` exactly; ``laplacian_loss`` to 1e-6."""
    pred, gt = _meshes(1)
    rng = np.random.default_rng(2)
    pose_p, pose_g, jm_p, jm_g = (rng.normal(size=(3, 21, 3)).astype(np.float32) * 30
                                  for _ in range(4))
    want = jax.jit(lambda *a: jloss.pose2mesh_losses(*a, faces=STRIP))(
        pred, gt, pose_p, pose_g, jm_p, jm_g)
    got = ploss.pose2mesh_losses(*map(_t, (pred, gt, pose_p, pose_g, jm_p, jm_g)),
                                 faces=STRIP)
    assert list(got) == ["mesh_coord", "pose_coord", "joint_coord", "normal", "edge",
                         "total_loss"] and set(want) == set(got)   # jit sorts dict keys
    for k in want:
        assert _rel_err(got[k].item(), float(want[k])) <= 1e-6, k
    masked = jloss.coord_l1(pred, gt, valid=(gt[..., :1] > 0).astype(np.float32))
    assert _rel_err(ploss.coord_l1(_t(pred), _t(gt), _t((gt[..., :1] > 0).astype(np.float32))),
                    masked) <= 1e-6
    lap = ploss.uniform_laplacian(STRIP, 778)
    want_lap = jloss.uniform_laplacian(STRIP, 778)
    assert lap.dtype == want_lap.dtype and np.array_equal(lap, want_lap)
    assert _rel_err(ploss.laplacian_loss(_t(pred), _t(lap)).item(),
                    float(jax.jit(jloss.laplacian_loss)(pred, want_lap))) <= 1e-6
    no_faces = ploss.pose2mesh_losses(*map(_t, (pred, gt, pose_p, pose_g)))
    assert list(no_faces) == ["mesh_coord", "pose_coord", "total_loss"]


def test_losses_gradients_match_jax():
    """The gradient of the app's total (mesh, pose, normal x0.1, edge x20)
    with respect to the predicted mesh and pose, to 1e-5 of its scale."""
    pred, gt = _meshes(3)
    rng = np.random.default_rng(4)
    pose_p, pose_g = (rng.normal(size=(3, 21, 3)).astype(np.float32) * 30 for _ in range(2))
    gt_j, pose_g_j = jnp.asarray(gt), jnp.asarray(pose_g)
    want = jax.jit(jax.grad(lambda m, p: jloss.pose2mesh_losses(m, gt_j, p, pose_g_j,
                                                                faces=STRIP)["total_loss"],
                            argnums=(0, 1)))(pred, pose_p)
    m, p = _t(pred).requires_grad_(), _t(pose_p).requires_grad_()
    ploss.pose2mesh_losses(m, _t(gt), p, _t(pose_g), faces=STRIP)["total_loss"].backward()
    for g, w in zip((m.grad, p.grad), want):
        assert _rel_err(g, w) <= 1e-5


# ---------------------------------------------------------------------------
# the batch maker


def test_batch_maker_draws_as_the_jax_app():
    """On the same ``default_rng(0)``, synthetic assets then two batches:
    the generator ends in the same state as the JAX app's formula (so the
    poses and betas drawn are the same, in the same order), MANO's verts
    and joints agree to 1e-5 of their scale, the normalized 2D input to
    1e-5."""
    rng_p, rng_j = np.random.default_rng(0), np.random.default_rng(0)
    assets_p = papp.load_assets(None, True, rng_p)
    assets_j = jmano.ManoAssets.synthetic(rng_j)
    assert np.array_equal(assets_p.v_template, assets_j.v_template)
    layer_p = papp.ManoLayer(assets_p, flat_hand_mean=True, device="cpu")
    mano_j = jax.jit(lambda p, b: jmano.ManoLayer(assets_j, flat_hand_mean=True)(p, b))
    for _ in range(2):
        pose2d, verts, joints = papp.make_batch(rng_p, layer_p, 4)
        pose = rng_j.normal(size=(4, 48)).astype(np.float32) * 0.3
        betas = rng_j.normal(size=(4, 10)).astype(np.float32) * 0.3
        verts_j, joints_j = mano_j(jnp.asarray(pose), jnp.asarray(betas))
        j2d = np.asarray(joints_j)[:, :, :2]
        j2d = (j2d - j2d.mean(1, keepdims=True)) / (j2d.std((1, 2), keepdims=True) + 1e-6)
        assert rng_p.bit_generator.state == rng_j.bit_generator.state
        assert verts.shape == (4, 778, 3) and joints.shape == (4, 21, 3)
        assert _rel_err(verts, verts_j) <= 1e-5 and _rel_err(joints, joints_j) <= 1e-5
        assert_close(pose2d, j2d, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the train step against the JAX app's


HID, LR, B = 64, 1e-3, 3


@pytest.fixture(scope="module")
def small_setup():
    """The random 80-vertex mesh of ``tests/test_torch_port_mesh.py`` and
    its pyramid with the app's joint graph (``HORI`` extra pairs), for both
    sides."""
    faces = random_mesh(np.random.default_rng(0))
    pyr = papp.build_pyramid(faces)
    jpyr = jgraph.build_graph_pyramid(faces, 21, japp.SKELETON, japp.HORI, levels=6)
    assert all(np.allclose(a, b, atol=1e-5) for a, b in zip(pyr.laplacians, jpyr.laplacians))
    jpyr = jgraph.GraphPyramid(laplacians=pyr.laplacians, perm=pyr.perm,
                               perm_reverse=pyr.perm_reverse, mesh_sizes=pyr.mesh_sizes)
    return faces, pyr, jpyr


def _step_batch(seed, n_verts):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, 21, 2)).astype(np.float32),
            rng.normal(size=(B, n_verts, 3)).astype(np.float32) * 50,
            rng.normal(size=(B, 21, 3)).astype(np.float32) * 50)


def _jax_app_step(model, faces, perm_rev, tx):
    """The JAX app's ``train_step`` (apps/train_pose2mesh.py:90-105)."""
    @jax.jit
    def train_step(params, bstats, opt_state, pose2d, verts_gt, joints_gt):
        def loss_fn(p):
            mesh, pose3d = model.apply({"params": p, "batch_stats": bstats}, pose2d, train=False)
            losses = jloss.pose2mesh_losses(mesh[:, perm_rev], verts_gt, pose3d, joints_gt,
                                            faces=faces)
            return losses["total_loss"], losses

        (_, losses), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state2 = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state2, losses

    return train_step


def _variables(model) -> dict:
    """The model's flax variables, copied: on the CPU a jitted JAX call may
    read numpy memory after returning, while the port's step writes the
    parameters in place."""
    return pose2mesh_variables_from_state_dict(
        {k: v.detach().clone() for k, v in model.state_dict().items()})


def _jax_opt_state(tx, state):
    """optax.adam's state holding the port's Adam moments and count, in the
    flax layout."""
    moments = {"mu": {}, "nu": {}}
    for name, p in state.model.named_parameters():
        adam = state.optimizer.state[p]      # empty before the first step
        for key, torch_key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            moments[key][name] = adam.get(torch_key, torch.zeros_like(p)).detach().clone()
    tree = {k: pose2mesh_variables_from_state_dict(v)["params"] for k, v in moments.items()}
    adam, scale = tx.init(tree["mu"])
    return adam._replace(count=jnp.asarray(state.step, jnp.int32), **tree), scale


# Pose2Mesh runs in eval mode (fixed BatchNorm statistics, no dropout). Each
# step starts from the same state on both sides (weights, Adam's moments and
# count), so the losses are a forward on the same weights (measured 1.7e-6 at
# worst, the normal term: the random init's mesh is 0.1 mm wide with edges
# down to 1e-4 mm, whose directions the term normalizes). Adam's first step
# moves every element by about +-lr whatever its gradient's size, so an
# element whose gradient is rounding noise moves either way: one such
# element of the 64 in cl1's bias (and of its BatchNorm's bias) makes those
# tensors differ by 24.7% of their change (the norm of the error over the
# norm of the change); the median tensor differs by 1.1e-5, the tree by
# 6.1e-3 (the second step: 3.0e-3, 8.6e-5, 1.0e-3). Each tensor is held to
# P2M_PARAM_TOL, the median to P2M_MEDIAN_TOL, the tree to P2M_TREE_TOL.
P2M_PARAM_TOL, P2M_MEDIAN_TOL, P2M_TREE_TOL, P2M_LOSS_TOL = 0.5, 1e-3, 2e-2, 1e-5


def test_train_steps_match_the_jax_app(small_setup):
    """Two steps of the port's ``train_step``, each against the JAX app's
    step from the same state (the port's init through
    ``convert_pose2mesh``, then the port's state after its first step):
    every loss term to 1e-5 relative, the parameters relative to the step's
    change (tolerances above); the BatchNorms' statistics stay at their
    init."""
    faces, pyr, jpyr = small_setup
    n_verts = int(faces.max()) + 1
    state = papp.init_state(pyr, LR, torch.device("cpu"),
                            pconfig.Pose2MeshConfig(posenet_hid=HID), seed=7)
    init_stats = _variables(state.model)["batch_stats"]
    tx = optax.adam(LR)
    step = _jax_app_step(jp2m.Pose2Mesh(pyramid=jpyr, cfg=jconfig.Pose2MeshConfig(posenet_hid=HID)),
                         faces, jnp.asarray(pyr.perm_reverse[:n_verts]), tx)
    order = _t(pyr.perm_reverse[:n_verts])
    for seed in (20, 21):
        batch = _step_batch(seed, n_verts)
        before = _variables(state.model)
        params, _, want = step(before["params"], before["batch_stats"],
                               _jax_opt_state(tx, state), *batch)
        got = papp.train_step(state, order, _t(faces), *map(_t, batch))
        assert list(got) == ["mesh_coord", "pose_coord", "normal", "edge", "total_loss"]
        assert set(got) == set(want)     # jit returns the dict's keys sorted
        for k in want:
            assert _rel_err(got[k].item(), float(want[k])) <= P2M_LOSS_TOL, k
        after = _variables(state.model)
        start, want_after = dict(_flat(before["params"])), dict(_flat(params))
        ratios, err_sq, change_sq = [], 0.0, 0.0
        for key, value in _flat(after["params"]):
            err = np.linalg.norm(value - want_after[key])
            change = np.linalg.norm(want_after[key] - start[key])
            ratios.append(err / change)
            err_sq, change_sq = err_sq + err ** 2, change_sq + change ** 2
        assert max(ratios) <= P2M_PARAM_TOL, max(ratios)
        assert np.median(ratios) <= P2M_MEDIAN_TOL, np.median(ratios)
        assert (err_sq / change_sq) ** 0.5 <= P2M_TREE_TOL, (err_sq / change_sq) ** 0.5
        assert leaves_equal(after["batch_stats"], init_stats)
    assert state.step == 2 and not state.model.training


def test_pose2mesh_variables_round_trip(small_setup):
    """``pose2mesh_variables_from_state_dict`` gives what
    ``convert_pose2mesh`` gives, leaf for leaf, and
    ``pose2mesh_state_dict_from_flax`` maps it back exactly."""
    _, pyr, _ = small_setup
    state = papp.init_state(pyr, LR, torch.device("cpu"),
                            pconfig.Pose2MeshConfig(posenet_hid=HID), seed=8)
    with torch.no_grad():
        for name, t in state.model.state_dict().items():
            if name.endswith(("running_mean", "running_var")):
                t.uniform_(0.5, 1.5)
    sd = state.model.state_dict()
    variables = pose2mesh_variables_from_state_dict(sd)
    assert leaves_equal(variables, convert_pose2mesh({k: v.numpy() for k, v in sd.items()}))
    back = pose2mesh_state_dict_from_flax(variables)
    assert sorted(back) == sorted(sd) and all(torch.equal(back[k], sd[k]) for k in sd)


# ---------------------------------------------------------------------------
# the entry point


def test_main_writes_params_that_the_jax_package_applies(tmp_path):
    """The port's app at its defaults (PoseNet 4096 x 2, the strip's
    pyramid with the ``HORI`` joint graph), 2 steps of batch 4 on the CPU:
    the losses are finite, ``params.npz`` holds the flax keys, and JAX's
    ``Pose2Mesh`` applied to them (with the statistics of the port's model)
    gives the port's mesh and pose to 1e-4 of their scale."""
    out = papp.main(["--synthetic", "--steps", "2", "--batch", "4", "--device", "cpu",
                     "--output", str(tmp_path)])
    assert len(out["losses"]) == 2 and all(np.isfinite(list(l.values())).all()
                                           for l in out["losses"])
    params = jckpt.load_params_npz(out["params_npz"])
    model = out["state"].model
    variables = pose2mesh_variables_from_state_dict(model.state_dict())
    assert leaves_equal(params, variables["params"])
    pyr = papp.build_pyramid(STRIP)
    jpyr = jgraph.GraphPyramid(laplacians=pyr.laplacians, perm=pyr.perm,
                               perm_reverse=pyr.perm_reverse, mesh_sizes=pyr.mesh_sizes)
    pose2d = np.random.default_rng(5).normal(size=(2, 21, 2)).astype(np.float32)
    want_mesh, want_pose = jax.jit(jp2m.Pose2Mesh(pyramid=jpyr).apply)(
        {"params": params, "batch_stats": variables["batch_stats"]}, pose2d)
    with torch.no_grad():
        mesh, pose3d = model(_t(pose2d))
    for got, want in ((mesh, want_mesh), (pose3d, want_pose)):
        assert_close(got, want, rtol=0, atol=1e-4 * float(np.abs(np.asarray(want)).max()))


def test_main_defaults_to_the_card(monkeypatch, tmp_path):
    """Without ``--device`` the app trains on the card: where there is none
    it raises instead of training on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        papp.main(["--synthetic", "--steps", "1", "--output", str(tmp_path)])
