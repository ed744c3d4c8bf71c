"""DexYCB HPE evaluation: MPJPE + AUC under absolute / root-relative /
Procrustes alignments, with the reference's exact result-file format.

Reference surfaces reproduced:
* ``EvalUtil`` (freihand/utils/eval_util.py:4-94) — per-keypoint distance
  store, PCK curve, trapezoid AUC. Rebuilt vectorized: one [S, K] distance
  matrix instead of 21 python lists.
* ``HPEEvaluator`` (dex-ycb-toolkit/dex_ycb_toolkit/hpe_eval.py:29-274) —
  result-file parsing (64 comma-separated fields/line: id + 21*3 coords,
  hpe_eval.py:123-135), AUC over 0-50mm / 100 steps (:24-26), three
  alignments (:198-218), tabulated report (:225-234).

The port's copy of ``handnet_tpu/eval/hpe.py``. The metric math runs in
numpy on the host (it is file-side); the Procrustes alignment is
``ops/geometry.py``'s ``align_w_scale_np``.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, Mapping, Optional, Tuple

import numpy as np

from handnet_tpu_torch.ops.geometry import align_w_scale_np

AUC_VAL_MIN = 0.0
AUC_VAL_MAX = 50.0
AUC_STEPS = 100


class EvalUtil:
    """PCK/AUC evaluator, vectorized (parity with freihand eval_util.py:4-94)."""

    def __init__(self, num_kp: int = 21):
        self.num_kp = num_kp
        self._dists: list = []
        self._vis: list = []

    def feed(self, keypoint_gt, keypoint_vis, keypoint_pred):
        gt = np.squeeze(np.asarray(keypoint_gt))
        pred = np.squeeze(np.asarray(keypoint_pred))
        vis = np.squeeze(np.asarray(keypoint_vis)).astype(bool)
        self._dists.append(np.linalg.norm(gt - pred, axis=-1))
        self._vis.append(vis)

    def feed_batch(self, gt: np.ndarray, pred: np.ndarray,
                   vis: Optional[np.ndarray] = None):
        """Batched feed ``[S, K, 3]`` — replaces the per-sample loop."""
        d = np.linalg.norm(np.asarray(gt) - np.asarray(pred), axis=-1)
        v = (np.ones(d.shape, bool) if vis is None else np.asarray(vis, bool))
        self._dists.extend(d)
        self._vis.extend(v)

    def get_measures(self, val_min: float = AUC_VAL_MIN,
                     val_max: float = AUC_VAL_MAX, steps: int = AUC_STEPS):
        """Returns (epe_mean, epe_median, auc, pck_curve, thresholds) — same
        contract as eval_util.py:53-94 (means taken over keypoints)."""
        dists = np.stack(self._dists)          # [S, K]
        vis = np.stack(self._vis)              # [S, K]
        thresholds = np.linspace(val_min, val_max, steps)
        norm = np.trapezoid(np.ones_like(thresholds), thresholds)

        epe_means, epe_medians, aucs, curves = [], [], [], []
        for k in range(dists.shape[1]):
            d = dists[vis[:, k], k]
            if d.size == 0:
                continue
            epe_means.append(d.mean())
            epe_medians.append(np.median(d))
            pck = (d[None, :] <= thresholds[:, None]).mean(axis=1)
            curves.append(pck)
            aucs.append(np.trapezoid(pck, thresholds) / norm)
        return (float(np.mean(epe_means)), float(np.mean(epe_medians)),
                float(np.mean(aucs)), np.mean(np.stack(curves), axis=0),
                thresholds)


def format_result_line(image_id: int, joints_xyz_mm: np.ndarray) -> str:
    """One 64-field result line: ``id,x1,y1,z1,...,z21`` — byte-compatible
    with the writer at a2j/a2j.py:354-362."""
    vals = ",".join(repr(float(v)) for v in np.asarray(joints_xyz_mm).reshape(-1))
    return f"{int(image_id)},{vals}"


def parse_result_file(path: str) -> Dict[int, np.ndarray]:
    """Parse a result file (hpe_eval.py:113-152 format contract)."""
    results: Dict[int, np.ndarray] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            elems = line.split(",")
            if len(elems) != 64:
                raise ValueError(
                    f"a line does not have 64 comma-separated elements: {line}")
            results[int(elems[0])] = np.array(elems[1:], np.float64).reshape(21, 3)
    return results


class HPEEvaluator:
    """MPJPE/AUC x {absolute, root-relative, procrustes}.

    GT comes from any mapping image_id -> [21, 3] (mm); dataset adapters
    provide it (data/dexycb.py). ``evaluate_arrays`` is the batched fast path;
    ``evaluate`` consumes a reference-format result file.
    """

    def __init__(self, joint_3d_gt: Mapping[int, np.ndarray],
                 out_dir: Optional[str] = None):
        self._gt = {int(k): np.asarray(v, np.float64)
                    for k, v in joint_3d_gt.items()}
        self._out_dir = out_dir
        self._epoch_metrics: Dict[str, Dict] = {"ab": {}, "rr": {}, "pa": {}}

    def evaluate(self, epoch, res_file: str) -> Dict[str, Dict[str, float]]:
        res = parse_result_file(res_file)
        return self.evaluate_dict(epoch, res)

    def evaluate_dict(self, epoch, res: Mapping[int, np.ndarray]
                      ) -> Dict[str, Dict[str, float]]:
        util_ab, util_rr, util_pa = EvalUtil(), EvalUtil(), EvalUtil()
        for i, gt in self._gt.items():
            if i not in res:
                continue  # hpe_eval.py:203-204 skips missing ids
            pred = np.asarray(res[i], np.float64)
            vis = np.ones(gt.shape[0])
            util_ab.feed(gt, vis, pred)
            util_rr.feed(gt - gt[0], vis, pred - pred[0])
            util_pa.feed(gt, vis, align_w_scale_np(gt, pred))

        out = {}
        for key, util, name in (("ab", util_ab, "absolute"),
                                ("rr", util_rr, "root-relative"),
                                ("pa", util_pa, "procrustes")):
            mean, _, auc, pck, thresh = util.get_measures()
            self._epoch_metrics[key][f"{epoch}"] = (mean, auc, pck, thresh)
            out[name] = {"mpjpe": mean, "auc": auc}
        return out

    def report(self, results: Dict[str, Dict[str, float]]) -> str:
        """Markdown-pipe table like the tabulate output at hpe_eval.py:225-234."""
        lines = ["| alignment | MPJPE (mm) | AUC |", "|---|---|---|"]
        for name in ("absolute", "root-relative", "procrustes"):
            r = results[name]
            lines.append(f"| {name} | {r['mpjpe']:.4f} | {r['auc']:.4f} |")
        return "\n".join(lines)

    def save_epoch_metrics(self, out_dir: str):
        import pickle

        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "hpe_epoch_metrics.pkl"), "wb") as f:
            pickle.dump(self._epoch_metrics, f)

    def save_pck_curves(self, out_dir: str, epoch) -> Optional[str]:
        """Emit the per-epoch PCK-curve HTML artifact — the reference's
        `hpe_curve_*` report (hpe_eval.py:240-250 -> freihand/eval.py:104-130
        curve/createHTML), rendered as self-contained inline SVG instead of
        base64 matplotlib PNGs (no GUI/matplotlib dependency).

        Returns the written path, or None when ``evaluate`` has not run for
        ``epoch`` yet."""
        from handnet_tpu_torch.utils.monitoring import _svg_line_plot

        key = f"{epoch}"
        if key not in self._epoch_metrics["ab"]:
            return None
        titles = {"ab": "PCK curve for absolute keypoint error",
                  "rr": "PCK curve for root-relative keypoint error",
                  "pa": "PCK curve for Procrustes aligned keypoint error"}
        charts = []
        for align in ("ab", "rr", "pa"):
            _, _, pck, thresh = self._epoch_metrics[align][key]
            charts.append(_svg_line_plot(list(np.asarray(thresh)),
                                         list(np.asarray(pck)),
                                         titles[align], w=520, h=300))
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"hpe_curve_{epoch}.html")
        with open(path, "w") as f:
            f.write("<!DOCTYPE html>\n<html><body><h1>Detailed results:"
                    "</h1>\n" + "\n".join(charts) + "\n</body></html>\n")
        return path
