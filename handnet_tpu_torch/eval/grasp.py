"""Grasp coverage/precision evaluation (handover-safety metric).

The port's copy of ``handnet_tpu/eval/grasp.py`` (numpy only, unchanged).

Reference: dex-ycb-toolkit/dex_ycb_toolkit/grasp_eval.py:47-664. The core
metric (:305-357): a predicted grasp "covers" a ground-truth grasp when their
translations are within ``radius`` AND the relative rotation angle is within
``angle``; coverage = fraction of GT grasps covered, precision = fraction of
(collision-free) predicted grasps that cover some GT grasp.

This module implements the FULL evaluator workflow (:359-649):
* hand point cloud from a detected mask + depth (:249-302),
* GT grasp set: object-frame grasp candidates placed at the GT object pose,
  filtered by collision against the GT object + GT MANO hand mesh (:515-527),
* predicted grasp sets per hand-distance threshold: candidates at the
  predicted object pose, collision-filtered against the predicted object and
  distance-filtered against the predicted hand point cloud (:549-569),
* the (radius, angle, dist_threshold) sweep with per-threshold GT-scene
  collision re-checks (:586-634) and the mean-over-scenes table (:640-660).

One deliberate substitution: the reference's FCL mesh-mesh collision
(trimesh.collision.CollisionManager) is replaced by a point-cloud proximity
test — the gripper's sampled point cloud vs scene surface points within
``collision_eps``. Dependency-free and symmetric-in-spirit; scenes where a
5 mm point-sample misses a true penetration are rare at these point counts.
The pyrender visualization path stays out of scope (host GL).

Grasps are [N, 7]: translation (x, y, z) + quaternion (w, x, y, z); grasp
candidates/meshes use meters (the reference divides BOP mm by 1000, :537).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# reference sweep grids (grasp_eval.py:34-36)
RADIUS = (0.05,)
ANGLES = (np.deg2rad(15),)
DIST_THRESHOLDS = (0.00, 0.01, 0.02, 0.03, 0.04, 0.05, 0.06, 0.07)


# Panda-gripper primitive geometry (meters, gripper/grasp frame: z = approach
# direction, fingers close along x). Dimensions follow the published Franka
# hand envelope (80 mm max opening, ~54 mm finger length, ~18x10 mm finger
# cross-section) — a primitive-box stand-in for the reference's
# assets/panda_pc.npy sample (grasp_eval.py:88-92).
_GRIPPER_BOXES = (
    # (center, half-extents)
    ((0.0, 0.0, -0.010), (0.040, 0.011, 0.010)),     # palm bar
    ((-0.035, 0.0, 0.027), (0.005, 0.009, 0.027)),   # left finger
    ((0.035, 0.0, 0.027), (0.005, 0.009, 0.027)),    # right finger
)


def panda_gripper_pc(n_points: int = 256, seed: int = 0) -> np.ndarray:
    """Surface point sample of the primitive Panda gripper, ``[n, 3]``.

    Points are spread over the box surfaces proportionally to area
    (deterministic given ``seed``). Density sets the collision check's
    resolution — see :func:`solid_penetration_sphere` and
    tests/test_grasp.py's calibration test for the measured miss bound.
    """
    rng = np.random.default_rng(seed)
    faces = []   # (origin, edge_u, edge_v, area)
    for (cx, cy, cz), (hx, hy, hz) in _GRIPPER_BOXES:
        c = np.array([cx, cy, cz])
        h = np.array([hx, hy, hz])
        for axis in range(3):
            u, v = (axis + 1) % 3, (axis + 2) % 3
            area = 4.0 * h[u] * h[v]
            for sign in (-1.0, 1.0):
                origin = c.copy()
                origin[axis] += sign * h[axis]
                eu = np.zeros(3)
                eu[u] = h[u]
                ev = np.zeros(3)
                ev[v] = h[v]
                faces.append((origin, eu, ev, area))
    areas = np.array([f[3] for f in faces])
    counts = np.maximum(
        np.round(areas / areas.sum() * n_points).astype(int), 1)
    # rounding can under-/overshoot n_points: top up the largest faces /
    # trim the smallest so the [n, 3] contract holds exactly
    order = np.argsort(-areas)
    i = 0
    while counts.sum() < n_points:
        counts[order[i % len(order)]] += 1
        i += 1
    while counts.sum() > n_points and counts.max() > 1:
        j = order[::-1][i % len(order)]
        if counts[j] > 1:
            counts[j] -= 1
        i += 1
    pts = []
    for (origin, eu, ev, _), k in zip(faces, counts):
        uv = rng.uniform(-1.0, 1.0, size=(k, 2))
        pts.append(origin + uv[:, :1] * eu + uv[:, 1:] * ev)
    # n_points below the 18-face minimum: slice the 1-per-face sample
    return np.concatenate(pts)[:n_points]


def solid_penetration_sphere(grasp_tf: np.ndarray, center: np.ndarray,
                             radius: float) -> float:
    """EXACT penetration depth of the solid primitive gripper into a sphere
    (positive = interpenetrating), the analytic oracle for calibrating the
    point-proximity collision substitute against the reference's FCL
    mesh-mesh check (grasp_eval.py:515-527).

    Uses the closed-form point-to-box distance per gripper box after
    transforming the sphere center into the gripper frame.
    """
    inv_r = grasp_tf[:3, :3].T
    c_local = inv_r @ (np.asarray(center, np.float64) - grasp_tf[:3, 3])
    best = np.inf
    for (bx, by, bz), (hx, hy, hz) in _GRIPPER_BOXES:
        d = np.abs(c_local - np.array([bx, by, bz])) - np.array([hx, hy, hz])
        outside = np.linalg.norm(np.maximum(d, 0.0))
        inside = min(float(np.max(d)), 0.0)   # negative when center in box
        best = min(best, outside + inside)
    return radius - best


def quat_conjugate(q: np.ndarray) -> np.ndarray:
    return q * np.array([1.0, -1.0, -1.0, -1.0])


def quat_multiply(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    w1, x1, y1, z1 = np.moveaxis(a, -1, 0)
    w2, x2, y2, z2 = np.moveaxis(b, -1, 0)
    return np.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], axis=-1)


def quat_rotation_angle(q: np.ndarray) -> np.ndarray:
    """|rotation angle| of unit quaternion(s), in radians."""
    w = np.clip(np.abs(q[..., 0]) / np.maximum(
        np.linalg.norm(q, axis=-1), 1e-12), -1.0, 1.0)
    return 2.0 * np.arccos(w)


def grasp_coverage(samples: np.ndarray, gt_poses: np.ndarray,
                   radius: float, angle: float
                   ) -> Tuple[int, np.ndarray]:
    """How many of ``gt_poses`` are covered by ``samples``
    (grasp_eval.py:305-357 semantics, vectorized — no kdtree needed at these
    set sizes).

    Returns (num_covered_gt, indices of covering samples).
    """
    if len(samples) == 0 or len(gt_poses) == 0:
        return 0, np.array([], np.int32)
    dist = np.linalg.norm(
        gt_poses[:, None, :3] - samples[None, :, :3], axis=-1)  # [G, S]
    rel = quat_multiply(quat_conjugate(gt_poses[:, None, 3:]),
                        samples[None, :, 3:])
    ang = quat_rotation_angle(rel)
    near = (dist <= radius) & (np.abs(ang) < angle)
    covered_gt = int((near.any(axis=1)).sum())
    covering = np.unique(np.nonzero(near.any(axis=0))[0]).astype(np.int32)
    return covered_gt, covering


def collision_free_mask(grasps_tf: np.ndarray, gripper_pc: np.ndarray,
                        hand_pc: np.ndarray,
                        collision_dist: float = 0.0) -> np.ndarray:
    """Point-based collision check: a grasp collides when any transformed
    gripper point is within ``collision_dist`` of the hand point cloud.

    grasps_tf [G, 4, 4]; gripper_pc [P, 3]; hand_pc [N, 3].
    """
    if len(hand_pc) == 0:
        return np.ones(len(grasps_tf), bool)
    out = np.ones(len(grasps_tf), bool)
    for i, tf in enumerate(grasps_tf):
        pts = gripper_pc @ tf[:3, :3].T + tf[:3, 3]
        d = np.linalg.norm(pts[:, None, :] - hand_pc[None, :, :], axis=-1)
        out[i] = d.min() > collision_dist
    return out


def quaternion_from_matrix(m: np.ndarray) -> np.ndarray:
    """Rotation matrix -> unit quaternion (w, x, y, z); Shepperd's method."""
    m = np.asarray(m, np.float64)[:3, :3]
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([0.25 * s, (m[2, 1] - m[1, 2]) / s,
                         (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s])
    i = int(np.argmax(np.diag(m)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(m[i, i] - m[j, j] - m[k, k] + 1.0) * 2
    q = np.empty(4)
    q[0] = (m[k, j] - m[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (m[j, i] + m[i, j]) / s
    q[1 + k] = (m[k, i] + m[i, k]) / s
    return q


def mats_to_tq(mats: Sequence[np.ndarray]) -> np.ndarray:
    """[G, 4, 4] world grasps -> [G, 7] (t, quat) rows (grasp_eval.py:520-523)."""
    if len(mats) == 0:
        return np.zeros((0, 7))
    return np.stack([np.concatenate([m[:3, 3], quaternion_from_matrix(m)])
                     for m in mats])


def hand_pc_from_mask(mask: np.ndarray, depth: np.ndarray,
                      fx: float, fy: float, ppx: float, ppy: float,
                      radius: float = 0.2) -> np.ndarray:
    """Hand point cloud from a segmentation mask + depth map (meters),
    median-centered outlier rejection (grasp_eval.py:249-302)."""
    h, w = depth.shape
    ys, xs = np.nonzero(np.asarray(mask, bool) & (depth > 0))
    z = depth[ys, xs]
    pc = np.stack([(xs - ppx) * z / fx, (ys - ppy) * z / fy, z], axis=1)
    if len(pc) > 0:
        center = np.median(pc, axis=0, keepdims=True)
        pc = pc[np.linalg.norm(pc - center, axis=1) < radius]
    return pc


def _min_dist_to(points: np.ndarray, cloud: np.ndarray) -> float:
    if len(cloud) == 0 or len(points) == 0:
        return np.inf
    # chunked pairwise to bound memory on large clouds
    best = np.inf
    for i in range(0, len(points), 256):
        d = np.linalg.norm(points[i:i + 256, None, :] - cloud[None, :, :],
                           axis=-1)
        best = min(best, float(d.min()))
    return best


@dataclass
class GraspScene:
    """Inputs for one evaluated frame (grasp_eval.py:473-560 assembly).

    All geometry in METERS, camera/world frame unless noted.
    ``candidate_grasps`` are the per-class gripper poses in OBJECT frame
    (the reference's ycb_farthest_100_grasps.json entries, :66-68).
    ``obj_pose_pred`` None == grasped object not detected (scene scores 0,
    :480-488).
    """

    candidate_grasps: np.ndarray                 # [G, 4, 4] object frame
    obj_pose_gt: np.ndarray                      # [4, 4]
    obj_pc: np.ndarray                           # [N, 3] model-frame surface
    obj_pose_pred: Optional[np.ndarray] = None   # [4, 4] or None
    hand_verts_gt: Optional[np.ndarray] = None   # [V, 3] world (None = no GT)
    hand_pc_pred: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 3)))  # [M, 3] world


class GraspEvaluator:
    """Scene-set coverage/precision sweeps over (radius, angle, threshold)
    grids (grasp_eval.py:586-649 aggregation)."""

    def __init__(self, radius: Sequence[float] = RADIUS,
                 angles: Sequence[float] = ANGLES,
                 dist_thresholds: Sequence[float] = DIST_THRESHOLDS,
                 gripper_pc: Optional[np.ndarray] = None,
                 collision_eps: float = 0.005):
        self.radius = tuple(radius)
        self.angles = tuple(angles)
        self.dist_thresholds = tuple(dist_thresholds)
        # default gripper sample: primitive-geometry Panda surface points
        # standing in for assets/panda_pc.npy[:100] (grasp_eval.py:88-92).
        # 256 points + eps from the measured calibration curve
        # (tools/calibrate_grasp_collision.py vs the exact solid oracle
        # solid_penetration_sphere) — see the numbers in that tool's
        # docstring / ROUND3_NOTES.
        if gripper_pc is None:
            gripper_pc = panda_gripper_pc(256)
        self.gripper_pc = np.asarray(gripper_pc)
        self.collision_eps = collision_eps

    def evaluate_scene(self, pred_grasps: np.ndarray, gt_grasps: np.ndarray,
                       pred_collision_free: np.ndarray | None = None
                       ) -> Dict:
        """pred/gt: [N, 7] pose+quat. Returns nested coverage/precision."""
        if pred_collision_free is None:
            pred_collision_free = np.ones(len(pred_grasps), bool)
        pred_ok = pred_grasps[pred_collision_free]
        coverage: Dict = {}
        precision: Dict = {}
        for r in self.radius:
            for a in self.angles:
                n_cov_gt, _ = grasp_coverage(pred_ok, gt_grasps, r, a)
                n_cov_pred, _ = grasp_coverage(gt_grasps, pred_ok, r, a)
                cov = n_cov_gt / max(len(gt_grasps), 1)
                prec = n_cov_pred / max(len(pred_ok), 1)
                coverage.setdefault(r, {})[a] = cov
                precision.setdefault(r, {})[a] = prec
        return {"coverage": coverage, "precision": precision}

    def _zero_sweep(self) -> Dict:
        return {r: {a: {t: 0.0 for t in self.dist_thresholds}
                    for a in self.angles} for r in self.radius}

    def _collides(self, grasp_w: np.ndarray, scene_pc: np.ndarray) -> bool:
        pts = self.gripper_pc @ grasp_w[:3, :3].T + grasp_w[:3, 3]
        return _min_dist_to(pts, scene_pc) <= self.collision_eps

    def evaluate_full_scene(self, scene: GraspScene) -> Dict:
        """The reference per-scene workflow (grasp_eval.py:480-634).

        Returns {'coverage': {r: {a: {thr: v}}}, 'precision': ...}.
        """
        coverage = self._zero_sweep()
        precision = self._zero_sweep()
        if scene.obj_pose_pred is None:
            # grasped object not detected (grasp_eval.py:480-488)
            return {"coverage": coverage, "precision": precision}

        obj_pc_gt = scene.obj_pc @ scene.obj_pose_gt[:3, :3].T \
            + scene.obj_pose_gt[:3, 3]
        gt_scene_pc = (np.concatenate([obj_pc_gt, scene.hand_verts_gt])
                       if scene.hand_verts_gt is not None else obj_pc_gt)

        # GT grasps: candidates at the GT pose, collision-free vs GT scene
        gt_grasps_m = [scene.obj_pose_gt @ g for g in scene.candidate_grasps]
        gt_grasps_m = [g for g in gt_grasps_m
                       if not self._collides(g, gt_scene_pc)]
        gt_grasps_q = mats_to_tq(gt_grasps_m)
        if len(gt_grasps_q) == 0:
            return {"coverage": coverage, "precision": precision}

        # predicted grasps per hand-distance threshold (grasp_eval.py:549-569)
        obj_pc_pred = scene.obj_pc @ scene.obj_pose_pred[:3, :3].T \
            + scene.obj_pose_pred[:3, 3]
        hand_pc = (scene.hand_pc_pred
                   if scene.hand_verts_gt is not None else np.zeros((0, 3)))
        pred_m: Dict[float, list] = {t: [] for t in self.dist_thresholds}
        for g_obj in scene.candidate_grasps:
            g_w = scene.obj_pose_pred @ g_obj
            if self._collides(g_w, obj_pc_pred):
                continue
            pts = self.gripper_pc @ g_w[:3, :3].T + g_w[:3, 3]
            min_dist = (_min_dist_to(pts, hand_pc) if len(hand_pc)
                        else max(self.dist_thresholds) + 1)
            for t in self.dist_thresholds:
                if min_dist > t:
                    pred_m[t].append(g_w)

        for t in self.dist_thresholds:
            if not pred_m[t]:
                continue
            # re-check collision against the GT scene (grasp_eval.py:592-599)
            cfree = np.array([not self._collides(g, gt_scene_pc)
                              for g in pred_m[t]])
            if not cfree.any():
                continue
            pred_q = mats_to_tq(pred_m[t])
            for r in self.radius:
                for a in self.angles:
                    n_cov_gt, _ = grasp_coverage(pred_q[cfree], gt_grasps_q,
                                                 r, a)
                    n_cov_pred, _ = grasp_coverage(gt_grasps_q, pred_q[cfree],
                                                   r, a)
                    coverage[r][a][t] = n_cov_gt / len(gt_grasps_q)
                    # reference divides by ALL kept grasps, not only the
                    # collision-free subset (grasp_eval.py:608)
                    precision[r][a][t] = n_cov_pred / len(pred_m[t])
        return {"coverage": coverage, "precision": precision}

    def evaluate_scenes(self, scenes: Sequence[GraspScene]
                        ) -> List[List[float]]:
        """Mean coverage/precision over scenes as table rows
        [radius, angle_deg, dist_th, coverage, precision]
        (grasp_eval.py:640-652)."""
        results = [self.evaluate_full_scene(s) for s in scenes]
        rows = []
        for r in self.radius:
            for a in self.angles:
                for t in self.dist_thresholds:
                    cov = float(np.mean([x["coverage"][r][a][t]
                                         for x in results]))
                    prec = float(np.mean([x["precision"][r][a][t]
                                          for x in results]))
                    rows.append([r, float(np.degrees(a)), t, cov, prec])
        return rows

    @staticmethod
    def format_table(rows: Sequence[Sequence[float]]) -> str:
        """The reference's results table shape (grasp_eval.py:646-659 /
        dex-ycb-toolkit README format), dependency-free."""
        header = ("| radius (m) | angle (deg) | dist th (m) | coverage | "
                  "precision |")
        sep = "|" + "|".join(["-" * 12] * 5) + "|"
        lines = [header, sep]
        for r, a, t, cov, prec in rows:
            lines.append(f"| {r:10.2f} | {a:11.0f} | {t:11.2f} "
                         f"| {cov:8.4f} | {prec:9.4f} |")
        return "\n".join(lines)

    def aggregate(self, scene_results: Sequence[Dict]) -> Dict[str, float]:
        out = {}
        for r in self.radius:
            for a in self.angles:
                cov = np.mean([s["coverage"][r][a] for s in scene_results])
                prec = np.mean([s["precision"][r][a] for s in scene_results])
                key = f"r{r:g}_a{np.degrees(a):.0f}"
                out[f"coverage_{key}"] = float(cov)
                out[f"precision_{key}"] = float(prec)
        return out
