"""6D object-pose error metrics + BOP-style average recall.

The port's copy of ``handnet_tpu/eval/bop_pose.py`` (numpy only, unchanged
but for VSD's renderer: the port's ``utils/raster.py``).

Reference: the vendored bop_toolkit's pose_error.py (ADD/ADI, rotation /
translation errors, MSSD/MSPD, VSD) driving BOPEvaluator
(dex-ycb-toolkit/dex_ycb_toolkit/bop_eval.py:53-288). Implemented here as
batched numpy over model point clouds; VSD renders depth with the
dependency-free software rasterizer (utils/raster.py) instead of the
reference's offscreen GL renderer (renderer_py.py:555).

All poses are (R [3,3], t [3]) in millimeters.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def transform_pts(pts: np.ndarray, R: np.ndarray, t: np.ndarray) -> np.ndarray:
    return pts @ R.T + t


def add_error(R_est, t_est, R_gt, t_gt, pts: np.ndarray) -> float:
    """Average distance of corresponding model points (ADD)."""
    est = transform_pts(pts, R_est, t_est)
    gt = transform_pts(pts, R_gt, t_gt)
    return float(np.linalg.norm(est - gt, axis=1).mean())


def adi_error(R_est, t_est, R_gt, t_gt, pts: np.ndarray) -> float:
    """Average closest-point distance (ADD-S / ADI, symmetric objects)."""
    est = transform_pts(pts, R_est, t_est)
    gt = transform_pts(pts, R_gt, t_gt)
    # nearest-neighbor via chunked pairwise distances (models are ~2-8k pts)
    nn = np.empty(len(gt))
    chunk = 512
    for i in range(0, len(gt), chunk):
        d = np.linalg.norm(gt[i:i + chunk, None, :] - est[None, :, :], axis=2)
        nn[i:i + chunk] = d.min(axis=1)
    return float(nn.mean())


def rotation_error(R_est: np.ndarray, R_gt: np.ndarray) -> float:
    """Geodesic rotation error in degrees."""
    cos = (np.trace(R_est @ R_gt.T) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))))


def translation_error(t_est: np.ndarray, t_gt: np.ndarray) -> float:
    return float(np.linalg.norm(np.asarray(t_est) - np.asarray(t_gt)))


def projection_error(R_est, t_est, R_gt, t_gt, K: np.ndarray,
                     pts: np.ndarray) -> float:
    """Mean 2D reprojection distance through intrinsics K."""
    def project(R, t):
        p = transform_pts(pts, R, t) @ K.T
        return p[:, :2] / p[:, 2:3]

    return float(np.linalg.norm(project(R_est, t_est) - project(R_gt, t_gt),
                                axis=1).mean())


def mssd(R_est, t_est, R_gt, t_gt, pts: np.ndarray,
         symmetries: Sequence[Tuple[np.ndarray, np.ndarray]] = ()) -> float:
    """Maximum symmetry-aware surface distance (BOP19)."""
    syms = list(symmetries) or [(np.eye(3), np.zeros(3))]
    best = np.inf
    est = transform_pts(pts, R_est, t_est)
    for Rs, ts in syms:
        gt = transform_pts(transform_pts(pts, Rs, ts), R_gt, t_gt)
        best = min(best, float(np.linalg.norm(est - gt, axis=1).max()))
    return best


def mspd(R_est, t_est, R_gt, t_gt, K: np.ndarray, pts: np.ndarray,
         symmetries: Sequence[Tuple[np.ndarray, np.ndarray]] = ()) -> float:
    """Maximum symmetry-aware projection distance (BOP19, pose_error.py:121-146)."""
    syms = list(symmetries) or [(np.eye(3), np.zeros(3))]

    def project(R, t):
        p = transform_pts(pts, R, t) @ K.T
        return p[:, :2] / p[:, 2:3]

    est = project(R_est, t_est)
    best = np.inf
    for Rs, ts in syms:
        gt_pts = transform_pts(transform_pts(pts, Rs, ts), R_gt, t_gt) @ K.T
        gt = gt_pts[:, :2] / gt_pts[:, 2:3]
        best = min(best, float(np.linalg.norm(est - gt, axis=1).max()))
    return best


def depth_to_dist(depth: np.ndarray, K: np.ndarray) -> np.ndarray:
    """Depth (Z) image -> distance-from-camera image
    (bop_toolkit_lib/misc.py:143-165 depth_im_to_dist_im_fast)."""
    h, w = depth.shape
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    xs = (np.arange(w) - cx) / fx
    ys = (np.arange(h) - cy) / fy
    scale = np.sqrt(xs[None, :] ** 2 + ys[:, None] ** 2 + 1.0)
    return depth * scale


def _visib_mask(d_test: np.ndarray, d_model: np.ndarray, delta: float
                ) -> np.ndarray:
    """'bop19' visibility: visible where the rendered surface is not behind
    the measured one by more than delta, or depth is missing
    (bop_toolkit_lib/visibility.py:34-37)."""
    d_diff = d_model.astype(np.float32) - d_test.astype(np.float32)
    return np.logical_and(np.logical_or(d_diff <= delta, d_test == 0),
                          d_model > 0)


def vsd(R_est, t_est, R_gt, t_gt, depth_test: np.ndarray, K: np.ndarray,
        verts: np.ndarray, faces: np.ndarray, diameter: float,
        delta: float = 15.0,
        taus: Sequence[float] = tuple(np.arange(0.05, 0.51, 0.05)),
        normalized_by_diameter: bool = True,
        cost_type: str = "step") -> List[float]:
    """Visible Surface Discrepancy (Hodan et al., ECCV'18) — one error per
    misalignment tolerance tau.

    Full reimplementation of bop_toolkit_lib/pose_error.py:17-93 using the
    software z-buffer renderer (utils/raster.py) in place of the GL
    renderer_py.py — the piece the reference needs an offscreen GL context
    for. ``verts``/``faces`` define the object mesh in model frame (mm);
    ``depth_test`` is the measured scene depth (mm).
    """
    from handnet_tpu_torch.utils.raster import render_depth

    h, w = depth_test.shape
    depth_est = render_depth(transform_pts(verts, np.asarray(R_est),
                                           np.asarray(t_est)), faces, K, h, w)
    depth_gt = render_depth(transform_pts(verts, np.asarray(R_gt),
                                          np.asarray(t_gt)), faces, K, h, w)

    dist_test = depth_to_dist(depth_test, K)
    dist_gt = depth_to_dist(depth_gt, K)
    dist_est = depth_to_dist(depth_est, K)

    visib_gt = _visib_mask(dist_test, dist_gt, delta)
    visib_est = _visib_mask(dist_test, dist_est, delta)
    # est-pose mask additionally keeps pixels occluded in the scene but
    # visible in the GT pose (visibility.py:58-75)
    visib_est = np.logical_or(visib_est,
                              np.logical_and(visib_gt, dist_est > 0))

    visib_inter = np.logical_and(visib_gt, visib_est)
    visib_union = np.logical_or(visib_gt, visib_est)
    union_count = int(visib_union.sum())
    comp_count = union_count - int(visib_inter.sum())

    dists = np.abs(dist_gt[visib_inter] - dist_est[visib_inter])
    if normalized_by_diameter:
        dists = dists / diameter

    if union_count == 0:
        return [1.0] * len(taus)
    errors = []
    for tau in taus:
        if cost_type == "step":
            costs = (dists >= tau).astype(np.float64)
        elif cost_type == "tlinear":
            costs = np.minimum(dists / tau, 1.0)
        else:
            raise ValueError(cost_type)
        errors.append(float((costs.sum() + comp_count) / union_count))
    return errors


def auc_add(errors: Sequence[float], max_threshold: float = 100.0,
            steps: int = 100) -> float:
    """PCK-style AUC of ADD errors (the common DexYCB object-pose summary)."""
    errors = np.asarray(errors, float)
    thresholds = np.linspace(0, max_threshold, steps)
    acc = (errors[None, :] <= thresholds[:, None]).mean(axis=1)
    return float(np.trapezoid(acc, thresholds) / max_threshold)


class BOPEvaluator:
    """Average recall over error thresholds, BOP19-style (VSD/MSSD/MSPD).

    models: object_id -> [N, 3] model points (mm); may be subsampled — used
        for the point-cloud metrics (ADD/MSSD/MSPD).
    diameters: object_id -> model diameter (mm) for relative thresholds.
    faces: object_id -> [F, 3] triangle indices — enables the render-based
        VSD term (reference bop_eval.py:74-80 error config). Faces index
        into ``mesh_verts`` when given, else into ``models`` (which must
        then be the FULL mesh vertex array, not a subsample).
    mesh_verts: object_id -> [V, 3] full mesh vertices for VSD rendering.
    symmetries: object_id -> list of (R, t) symmetry transforms.

    Aggregation matches dex_ycb_toolkit/bop_eval.py:140-213: AR_vsd averages
    recall over taus 0.05..0.5 x thresholds 0.05..0.5; AR_mssd over
    0.05d..0.5d; AR_mspd over 5..50 px; 'mean' averages the three.
    """

    def __init__(self, models: Dict[int, np.ndarray],
                 diameters: Dict[int, float],
                 faces: Dict[int, np.ndarray] | None = None,
                 symmetries: Dict[int, list] | None = None,
                 mesh_verts: Dict[int, np.ndarray] | None = None):
        self.models = models
        self.diameters = diameters
        self.faces = faces or {}
        self.symmetries = symmetries or {}
        self.mesh_verts = mesh_verts or {}
        for obj_id, f in self.faces.items():
            verts = self.mesh_verts.get(obj_id, self.models.get(obj_id))
            if verts is not None and int(np.max(f)) >= len(verts):
                raise ValueError(
                    f"obj {obj_id}: faces index up to {int(np.max(f))} but "
                    f"only {len(verts)} vertices available — pass the full "
                    f"mesh via mesh_verts (models may be subsampled)")

    def evaluate(self, estimates: List[Dict], ground_truth: List[Dict],
                 depth_images: Dict | None = None,
                 K: np.ndarray | None = None,
                 vsd_delta: float = 15.0) -> Dict[str, float]:
        """Each record: {image_id, obj_id, R, t}; estimates may add 'score'.

        ``depth_images`` maps image_id -> measured depth [H, W] (mm) and,
        together with intrinsics ``K`` and per-object ``faces``, turns on
        the VSD term; without them the result carries MSSD/MSPD/ADD only.
        """
        gt_by = {(g["image_id"], g["obj_id"]): g for g in ground_truth}
        add_hits, mssd_recalls, mspd_recalls, vsd_recalls, n = [], [], [], [], 0
        errors_add = []
        taus = np.arange(0.05, 0.51, 0.05)
        for est in estimates:
            key = (est["image_id"], est["obj_id"])
            if key not in gt_by:
                continue
            gt = gt_by[key]
            pts = self.models[est["obj_id"]]
            diam = self.diameters[est["obj_id"]]
            syms = self.symmetries.get(est["obj_id"], ())
            err = adi_error(est["R"], est["t"], gt["R"], gt["t"], pts)
            errors_add.append(err)
            add_hits.append(err < 0.1 * diam)
            e_mssd = mssd(est["R"], est["t"], gt["R"], gt["t"], pts, syms)
            ths = taus * diam
            mssd_recalls.append(float((e_mssd < ths).mean()))
            if K is not None:
                e_mspd = mspd(est["R"], est["t"], gt["R"], gt["t"], K, pts,
                              syms)
                mspd_recalls.append(
                    float((e_mspd < np.arange(5, 51, 5)).mean()))
            if (depth_images is not None and K is not None
                    and est["obj_id"] in self.faces
                    and est["image_id"] in depth_images):
                verts = self.mesh_verts.get(est["obj_id"], pts)
                errs = vsd(est["R"], est["t"], gt["R"], gt["t"],
                           depth_images[est["image_id"]], K, verts,
                           self.faces[est["obj_id"]], diam, delta=vsd_delta,
                           taus=taus)
                vsd_recalls.append(
                    float(np.mean([(e < taus).mean() for e in errs])))
            n += 1
        out = {
            "add_s_recall_0.1d": float(np.mean(add_hits)) if n else 0.0,
            "ar_mssd": float(np.mean(mssd_recalls)) if n else 0.0,
            "auc_add_s": auc_add(errors_add) if n else 0.0,
            "n_evaluated": n,
        }
        if mspd_recalls:
            out["ar_mspd"] = float(np.mean(mspd_recalls))
        if vsd_recalls:
            out["ar_vsd"] = float(np.mean(vsd_recalls))
        if mspd_recalls and vsd_recalls:
            out["mean_ar"] = float(np.mean([out["ar_vsd"], out["ar_mssd"],
                                            out["ar_mspd"]]))
        return out
