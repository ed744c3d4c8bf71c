"""The port's COCO, BOP and grasp evaluators (``eval/coco_det.py``,
``eval/bop_pose.py``, ``eval/grasp.py``) against the JAX package's, on the
CPU.

The port's modules are numpy copies, so every result must agree
**exactly** (``==`` on floats, dicts compared whole): the JAX tests' own
inputs (tests/test_eval_extra.py, tests/test_grasp.py, tests/test_raster.py's
VSD) and seeded random scenes. The segm task's masks go through each
package's own RLE codec, and VSD through each package's own rasterizer,
which must agree bit for bit too.
"""

import numpy as np
import pytest

from handnet_tpu.data import rle as jrle
from handnet_tpu.eval import bop_pose as jbop
from handnet_tpu.eval import coco_det as jcoco
from handnet_tpu.eval import grasp as jgrasp
from handnet_tpu.eval import voc as jvoc
from handnet_tpu_torch.data import rle as prle
from handnet_tpu_torch.eval import bop_pose as pbop
from handnet_tpu_torch.eval import coco_det as pcoco
from handnet_tpu_torch.eval import grasp as pgrasp
from handnet_tpu_torch.eval import voc as pvoc
from test_grasp import box_pc, grasp_above, rot_z
from test_raster import K as RASTER_K
from test_raster import square_mesh


def _random_rotation(rng):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return q


def _both(records_fn):
    """The same records built with each package's record types."""
    return records_fn(jvoc), records_fn(pvoc)


# ---------------------------------------------------------------------------
# COCO

def _box(x1, y1, x2, y2):
    return np.array([x1, y1, x2, y2], float)


def _jax_test_cases(voc):
    """tests/test_eval_extra.py's three bbox cases."""
    cup = voc.GTObject
    return [
        ({"im0": [cup("cup", _box(10, 10, 50, 50))], "im1": [cup("cup", _box(20, 20, 70, 80))]},
         [voc.Detection("im0", 0.9, _box(10, 10, 50, 50)),
          voc.Detection("im1", 0.8, _box(20, 20, 70, 80))]),
        ({"im0": [cup("cup", _box(10, 10, 50, 50))]},
         [voc.Detection("im0", 0.9, _box(10, 10, 44, 44))]),
        ({"im0": [cup("cup", _box(10, 10, 50, 50))]},
         [voc.Detection("im0", 0.95, _box(200, 200, 240, 240)),
          voc.Detection("im0", 0.9, _box(10, 10, 50, 50))]),
    ]


def _random_scene(voc, seed, n_images=6, classes=("cup", "hand", "box")):
    """Seeded GT objects of three classes and detections around them: jittered
    copies, misses, duplicates and false positives, with their labels."""
    rng = np.random.default_rng(seed)
    annotations, dets, labels = {}, [], []
    for i in range(n_images):
        objs = []
        for _ in range(rng.integers(1, 5)):
            x1, y1 = rng.uniform(0, 200, 2)
            w, h = rng.uniform(8, 120, 2)
            objs.append(voc.GTObject(str(rng.choice(classes)), _box(x1, y1, x1 + w, y1 + h)))
        annotations[f"im{i}"] = objs
        for o in objs:
            for _ in range(rng.integers(0, 3)):
                jitter = rng.normal(0, 0.08, 4) * (o.bbox[2:] - o.bbox[:2]).repeat(2)
                dets.append(voc.Detection(f"im{i}", float(rng.uniform()), o.bbox + jitter))
                labels.append(o.name if rng.uniform() < 0.9 else str(rng.choice(classes)))
        for _ in range(rng.integers(0, 3)):
            x1, y1 = rng.uniform(0, 250, 2)
            dets.append(voc.Detection(f"im{i}", float(rng.uniform()),
                                      _box(x1, y1, x1 + 30, y1 + 30)))
            labels.append(str(rng.choice(classes)))
    return annotations, dets, labels


@pytest.mark.parametrize("case", range(3))
def test_coco_bbox_matches_jax_on_its_tests(case):
    (j_annos, j_dets), (p_annos, p_dets) = (c[case] for c in _both(_jax_test_cases))
    labels = ["cup"] * len(j_dets)
    want = jcoco.CocoDetEvaluator(j_annos).evaluate(j_dets, labels)
    assert pcoco.CocoDetEvaluator(p_annos).evaluate(p_dets, labels) == want


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coco_bbox_matches_jax_on_random_scenes(seed):
    (j_annos, j_dets, labels), (p_annos, p_dets, _) = _both(lambda v: _random_scene(v, seed))
    for max_dets in (100, 2):
        want = jcoco.CocoDetEvaluator(j_annos, max_dets).evaluate(j_dets, labels)
        got = pcoco.CocoDetEvaluator(p_annos, max_dets).evaluate(p_dets, labels)
        assert got == want and 0.0 < want["AP"] < 1.0


def _masks(rle, records, rng, h=240, w=320):
    """A random blob inside each record's box, RLE-encoded by ``rle``."""
    out = {}
    for r in records:
        m = np.zeros((h, w), np.uint8)
        x1, y1, x2, y2 = np.clip(r.bbox, 0, [w - 1, h - 1, w - 1, h - 1]).astype(int)
        m[y1:y2 + 1, x1:x2 + 1] = rng.uniform(size=(y2 - y1 + 1, x2 - x1 + 1)) < 0.7
        out[id(r)] = rle.encode(np.asfortranarray(m))
    return out


def test_coco_segm_matches_jax():
    """The segm task over random blob masks, each side through its own RLE
    codec (the port's and the JAX package's encodings are equal too)."""
    (j_annos, j_dets, labels), (p_annos, p_dets, _) = _both(lambda v: _random_scene(v, 3))
    j_gt = [o for objs in j_annos.values() for o in objs]
    p_gt = [o for objs in p_annos.values() for o in objs]
    masks = []
    for rle, gt, dets in ((jrle, j_gt, j_dets), (prle, p_gt, p_dets)):
        rng = np.random.default_rng(30)
        masks.append((_masks(rle, gt, rng), _masks(rle, dets, rng)))
    (j_gtm, j_dtm), (p_gtm, p_dtm) = masks
    assert [p_gtm[id(o)] for o in p_gt] == [j_gtm[id(o)] for o in j_gt]
    want = jcoco.CocoDetEvaluator(j_annos).evaluate(j_dets, labels, iou_type="segm",
                                                    dt_masks=j_dtm, gt_masks=j_gtm)
    got = pcoco.CocoDetEvaluator(p_annos).evaluate(p_dets, labels, iou_type="segm",
                                                   dt_masks=p_dtm, gt_masks=p_gtm)
    assert got == want and 0.0 < want["AP"] < 1.0


def test_coco_keypoints_matches_jax():
    """OKS over 21 joints; one GT in three has no visible joint, so the
    pycocotools fallback (distances outside the 2x box) decides its
    matches, which count as neither TP nor FP."""
    (j_annos, j_dets, _), (p_annos, p_dets, _) = _both(
        lambda v: _random_scene(v, 4, classes=("hand",)))
    kpts = []
    for annos, dets in ((j_annos, j_dets), (p_annos, p_dets)):
        rng = np.random.default_rng(40)
        gt_k, dt_k = {}, {}
        for i, o in enumerate(o for objs in annos.values() for o in objs):
            xy = o.bbox[:2] + rng.uniform(size=(21, 2)) * (o.bbox[2:] - o.bbox[:2])
            gt_k[id(o)] = np.concatenate([xy, np.full((21, 1), float(i % 3 != 0))], axis=1)
        for d in dets:
            # the joints of the GT whose box centre is nearest, a few px off
            objs = annos[d.image_id]
            near = min(objs, key=lambda o: np.abs(o.bbox - d.bbox).sum())
            dt_k[id(d)] = gt_k[id(near)][:, :2] + rng.normal(0.0, 4.0, size=(21, 2))
        kpts.append((gt_k, dt_k))
    labels = ["hand"] * len(j_dets)
    want = jcoco.CocoDetEvaluator(j_annos).evaluate(
        j_dets, labels, iou_type="keypoints", gt_keypoints=kpts[0][0], dt_keypoints=kpts[0][1])
    got = pcoco.CocoDetEvaluator(p_annos).evaluate(
        p_dets, labels, iou_type="keypoints", gt_keypoints=kpts[1][0], dt_keypoints=kpts[1][1])
    assert got == want and 0.0 < want["AP"] < 1.0


def test_coco_refuses_like_jax():
    for module in (jcoco, pcoco):
        ev = module.CocoDetEvaluator({"a": []})
        for kwargs, match in (({"iou_type": "mask"}, "mask"),
                              ({"iou_type": "segm"}, "dt_masks"),
                              ({"iou_type": "keypoints"}, "keypoints")):
            with pytest.raises(ValueError, match=match):
                ev.evaluate([], [], **kwargs)


# ---------------------------------------------------------------------------
# BOP

def _poses(seed):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(300, 3)) * 40
    r1, r2 = _random_rotation(rng), _random_rotation(rng)
    t1 = rng.normal(size=3) * 20 + [0, 0, 600]
    t2 = t1 + rng.normal(size=3) * 5
    k = np.array([[600, 0, 320], [0, 600, 240], [0, 0, 1.0]])
    syms = [(np.eye(3), np.zeros(3)), (rot_z(np.pi)[:3, :3], np.zeros(3))]
    return pts, r1, t1, r2, t2, k, syms


@pytest.mark.parametrize("seed", [0, 1])
def test_bop_errors_match_jax(seed):
    pts, r1, t1, r2, t2, k, syms = _poses(seed)
    for name in ("add_error", "adi_error"):
        assert getattr(pbop, name)(r1, t1, r2, t2, pts) == getattr(jbop, name)(r1, t1, r2, t2, pts)
    assert pbop.rotation_error(r1, r2) == jbop.rotation_error(r1, r2)
    assert pbop.translation_error(t1, t2) == jbop.translation_error(t1, t2)
    assert (pbop.projection_error(r1, t1, r2, t2, k, pts)
            == jbop.projection_error(r1, t1, r2, t2, k, pts))
    assert pbop.mssd(r1, t1, r2, t2, pts, syms) == jbop.mssd(r1, t1, r2, t2, pts, syms)
    assert pbop.mspd(r1, t1, r2, t2, k, pts, syms) == jbop.mspd(r1, t1, r2, t2, k, pts, syms)
    errors = np.random.default_rng(seed).uniform(0, 150, 50)
    assert pbop.auc_add(errors) == jbop.auc_add(errors)


def test_vsd_matches_jax_on_raster_tests():
    """tests/test_raster.py's VSD scenes (identical, disjoint and depth
    offsets), step and tlinear costs, through each package's rasterizer."""
    v, f = square_mesh(z=0.0, half=60.0)
    r = np.eye(3)
    t_gt = np.array([0.0, 0.0, 500.0])
    diam = float(np.linalg.norm(v.max(0) - v.min(0)))
    depth = jbop.depth_to_dist(np.ones((96, 128)), RASTER_K)
    assert np.array_equal(pbop.depth_to_dist(np.ones((96, 128)), RASTER_K), depth)
    from handnet_tpu.utils.raster import render_depth
    depth_test = render_depth(v + t_gt, f, RASTER_K, 96, 128)
    for t_est in (t_gt, np.array([5000.0, 0.0, 500.0]), t_gt + [0, 0, 20.0],
                  t_gt + [3.0, -2.0, 60.0]):
        for cost in ("step", "tlinear"):
            args = (r, t_est, r, t_gt, depth_test, RASTER_K, v, f, diam)
            assert (pbop.vsd(*args, cost_type=cost, taus=[0.05, 0.2, 0.5])
                    == jbop.vsd(*args, cost_type=cost, taus=[0.05, 0.2, 0.5]))


def _bop_inputs(seed, h=48, w=64):
    """A seeded tetrahedron-fan mesh, GT poses and estimates around them over
    three images, and measured depth (the GT render plus noise)."""
    rng = np.random.default_rng(seed)
    verts = rng.normal(size=(40, 3)) * 30
    faces = rng.integers(0, 40, size=(60, 3))
    k = np.array([[80.0, 0, w / 2], [0, 80.0, h / 2], [0, 0, 1]])
    gt, est, depth = [], [], {}
    from handnet_tpu.utils.raster import render_depth
    for i in range(3):
        r = _random_rotation(rng)
        t = np.array([0.0, 0.0, 400.0]) + rng.normal(size=3) * 10
        gt.append({"image_id": i, "obj_id": 1, "R": r, "t": t})
        est.append({"image_id": i, "obj_id": 1, "R": _random_rotation(rng) if i == 2 else r,
                    "t": t + rng.normal(size=3) * 4 * (i + 1), "score": 0.5})
        d = render_depth(verts @ r.T + t, faces, k, h, w)
        depth[i] = np.where(d > 0, d + rng.normal(size=d.shape), 0.0)
    return verts, faces, k, gt, est, depth


def test_bop_evaluator_matches_jax():
    """``BOPEvaluator`` with MSSD, MSPD, ADD-S and VSD (mesh faces into
    ``mesh_verts``, points subsampled), and refusing faces beyond the
    subsample, as JAX's does."""
    verts, faces, k, gt, est, depth = _bop_inputs(5)
    kwargs = dict(models={1: verts[::2]}, diameters={1: 120.0}, faces={1: faces},
                  symmetries={1: [(np.eye(3), np.zeros(3))]}, mesh_verts={1: verts})
    want = jbop.BOPEvaluator(**kwargs).evaluate(est, gt, depth_images=depth, K=k)
    got = pbop.BOPEvaluator(**kwargs).evaluate(est, gt, depth_images=depth, K=k)
    assert got == want and {"ar_vsd", "ar_mspd", "mean_ar"} <= set(want)
    assert pbop.BOPEvaluator(**kwargs).evaluate(est, gt) == jbop.BOPEvaluator(
        **kwargs).evaluate(est, gt)
    for module in (jbop, pbop):
        with pytest.raises(ValueError, match="mesh_verts"):
            module.BOPEvaluator({1: verts[::2]}, {1: 120.0}, faces={1: faces})


# ---------------------------------------------------------------------------
# grasps

def _tq(rng, n):
    t = rng.normal(size=(n, 3)) * 0.02 + [0, 0, 0.5]
    q = rng.normal(size=(n, 4))
    return np.concatenate([t, q / np.linalg.norm(q, axis=1, keepdims=True)], axis=1)


def test_grasp_primitives_match_jax():
    rng = np.random.default_rng(7)
    assert np.array_equal(pgrasp.panda_gripper_pc(256), jgrasp.panda_gripper_pc(256))
    tf = np.eye(4)
    tf[:3, :3] = _random_rotation(rng)
    tf[:3, 3] = rng.normal(size=3) * 0.05
    for center in rng.normal(size=(8, 3)) * 0.05:
        assert (pgrasp.solid_penetration_sphere(tf, center, 0.01)
                == jgrasp.solid_penetration_sphere(tf, center, 0.01))
    a, b = _tq(rng, 30), _tq(rng, 40)
    for fn in ("quat_conjugate", "quat_rotation_angle"):
        assert np.array_equal(getattr(pgrasp, fn)(a[:, 3:]), getattr(jgrasp, fn)(a[:, 3:]))
    assert np.array_equal(pgrasp.quat_multiply(a[:, 3:], a[:, 3:]),
                          jgrasp.quat_multiply(a[:, 3:], a[:, 3:]))
    for radius, angle in ((0.01, np.deg2rad(15)), (0.05, np.deg2rad(60))):
        got = pgrasp.grasp_coverage(a, b, radius, angle)
        want = jgrasp.grasp_coverage(a, b, radius, angle)
        assert got[0] == want[0] and np.array_equal(got[1], want[1])
    mats = [rot_z(x) @ tf for x in (0.0, 0.4, 2.0, np.pi - 0.1)]
    assert np.array_equal(pgrasp.mats_to_tq(mats), jgrasp.mats_to_tq(mats))
    grasps = np.stack(mats)
    hand = rng.normal(size=(50, 3)) * 0.05
    gripper = pgrasp.panda_gripper_pc(64)
    assert np.array_equal(pgrasp.collision_free_mask(grasps, gripper, hand, 0.01),
                          jgrasp.collision_free_mask(grasps, gripper, hand, 0.01))
    depth = rng.uniform(0.4, 0.6, size=(24, 32)).astype(np.float32)
    depth[0, :4] = 5.0
    mask = rng.uniform(size=(24, 32)) < 0.5
    args = (mask, depth, 100.0, 100.0, 16.0, 12.0)
    assert np.array_equal(pgrasp.hand_pc_from_mask(*args), jgrasp.hand_pc_from_mask(*args))


def _jax_test_scenes(module):
    """tests/test_grasp.py's full scenes: perfect, undetected, near-hand
    grasp pruned by distance, GT-hand collision."""
    pose = np.eye(4)
    pose[:3, 3] = [0.0, 0.0, 0.6]
    eight = np.stack([grasp_above(0.12, a) for a in np.linspace(0, np.pi, 8, endpoint=False)])
    two = np.stack([grasp_above(0.12, 0.0), grasp_above(0.12, np.pi / 2)])
    near_far = np.stack([grasp_above(0.12, 0.0), grasp_above(0.30, 0.0)])
    scene = module.GraspScene
    return [
        scene(candidate_grasps=eight, obj_pose_gt=pose, obj_pc=box_pc(),
              obj_pose_pred=pose.copy()),
        scene(candidate_grasps=eight[:1], obj_pose_gt=np.eye(4), obj_pc=box_pc(),
              obj_pose_pred=None),
        scene(candidate_grasps=two, obj_pose_gt=pose, obj_pc=box_pc(), obj_pose_pred=pose.copy(),
              hand_verts_gt=pose[:3, 3][None] + np.array([[0.0, 0.2, 0.0]]),
              hand_pc_pred=(pose[:3, 3] + np.array([0.045, 0.0, 0.17]))[None]),
        scene(candidate_grasps=near_far, obj_pose_gt=pose, obj_pc=box_pc(),
              obj_pose_pred=pose.copy(), hand_verts_gt=pose[:3, 3] + np.array([[0, 0, 0.17]])),
    ]


def _random_scenes(module, seed, n=2, candidates=12):
    """Seeded scenes: candidates around a box, the predicted pose off the GT
    by a few millimetres and degrees, a GT hand mesh and a predicted hand
    cloud near some of the candidates."""
    rng = np.random.default_rng(seed)
    scenes = []
    for _ in range(n):
        cands = []
        for _ in range(candidates):
            g = rot_z(rng.uniform(0, 2 * np.pi))
            g[:3, :3] = _random_rotation(rng) @ g[:3, :3]
            g[:3, 3] = g[:3, :3] @ np.array([0, 0, -rng.uniform(0.09, 0.14)])
            cands.append(g)
        gt = np.eye(4)
        gt[:3, :3] = _random_rotation(rng)
        gt[:3, 3] = [0.0, 0.0, 0.6]
        pred = gt.copy()
        pred[:3, :3] = rot_z(rng.normal() * 0.1)[:3, :3] @ gt[:3, :3]
        pred[:3, 3] += rng.normal(size=3) * 0.005
        hand = gt[:3, 3] + rng.normal(size=(40, 3)) * 0.03 + [0.0, 0.09, 0.0]
        scenes.append(module.GraspScene(
            candidate_grasps=np.stack(cands), obj_pose_gt=gt, obj_pc=box_pc(0.03, 6),
            obj_pose_pred=pred, hand_verts_gt=hand,
            hand_pc_pred=hand + rng.normal(size=hand.shape) * 0.004))
    return scenes


@pytest.mark.parametrize("scenes", ["jax_tests", "random"])
def test_grasp_evaluator_matches_jax(scenes):
    """``evaluate_full_scene`` per scene, the sweep's table rows and their
    text at the reference's grids (8 distance thresholds), and the
    per-scene ``evaluate_scene``/``aggregate``."""
    build = _jax_test_scenes if scenes == "jax_tests" else (lambda m: _random_scenes(m, 11))
    j_scenes, p_scenes = build(jgrasp), build(pgrasp)
    j_ev, p_ev = jgrasp.GraspEvaluator(), pgrasp.GraspEvaluator()
    for j, p in zip(j_scenes, p_scenes):
        assert p_ev.evaluate_full_scene(p) == j_ev.evaluate_full_scene(j)
    rows = j_ev.evaluate_scenes(j_scenes)
    assert p_ev.evaluate_scenes(p_scenes) == rows and len(rows) == 8
    assert p_ev.format_table(rows) == j_ev.format_table(rows)
    if scenes == "random":
        assert any(0.0 < r[3] < 1.0 for r in rows)      # a sweep that discriminates
    rng = np.random.default_rng(12)
    pred, gt = _tq(rng, 20), _tq(rng, 15)
    kept = rng.uniform(size=20) < 0.8
    sweep = dict(radius=(0.01, 0.02), angles=(np.deg2rad(15), np.deg2rad(30)))
    want = jgrasp.GraspEvaluator(**sweep).evaluate_scene(pred, gt, kept)
    got = pgrasp.GraspEvaluator(**sweep).evaluate_scene(pred, gt, kept)
    assert got == want
    assert (pgrasp.GraspEvaluator(**sweep).aggregate([got])
            == jgrasp.GraspEvaluator(**sweep).aggregate([want]))
