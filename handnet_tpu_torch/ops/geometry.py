"""Camera geometry and joint-space conversions, batched over leading dims.

Counterparts of ``handnet_tpu/ops/geometry.py:18-122`` (reference
datasets3d/a2jdataset.py:21-38 and a2j/a2j.py:17-43), the evaluator's
numpy Procrustes alignment (``:69-99``; reference freihand/eval.py:71-94)
and its batched version in torch (:func:`align_w_scale`).
"""

from __future__ import annotations

import numpy as np
import torch


def xyz2uvd(pts: torch.Tensor, paras: torch.Tensor) -> torch.Tensor:
    """Project camera XYZ ``[..., J, 3]`` to pixel UVD with ``paras = [fx,
    fy, cx, cy]`` of shape ``[..., 4]``."""
    f = paras[..., None, 0:2]
    c = paras[..., None, 2:4]
    uv = pts[..., 0:2] * f / pts[..., 2:3] + c
    return torch.cat([uv, pts[..., 2:3]], dim=-1)


def uvd2xyz(pts: torch.Tensor, paras: torch.Tensor) -> torch.Tensor:
    """Unproject pixel UVD ``[..., J, 3]`` to camera XYZ with
    ``paras = [fx, fy, cx, cy]`` of shape ``[..., 4]``."""
    f = paras[..., None, 0:2]
    c = paras[..., None, 2:4]
    xy = (pts[..., 0:2] - c) * pts[..., 2:3] / f
    return torch.cat([xy, pts[..., 2:3]], dim=-1)


def crop_uvd_to_image_uvd(jt_uvd: torch.Tensor, box: torch.Tensor,
                          crop_w: int, crop_h: int) -> torch.Tensor:
    """Map crop-frame UVD back to full-image UVD given the crop box
    (a2j/a2j.py:25-30: u' = u * (x2-x1)/crop_w + x1; depth passes through)."""
    x1 = box[..., None, 0]
    y1 = box[..., None, 1]
    x2 = box[..., None, 2]
    y2 = box[..., None, 3]
    u = jt_uvd[..., 0] * (x2 - x1) / crop_w + x1
    v = jt_uvd[..., 1] * (y2 - y1) / crop_h + y1
    return torch.stack([u, v, jt_uvd[..., 2]], dim=-1)


def convert_joints(jt_uvd: torch.Tensor, box: torch.Tensor, paras: torch.Tensor,
                   crop_w: int = 176, crop_h: int = 176) -> torch.Tensor:
    """Crop UVD -> XYZ in millimeters (reference a2j/a2j.py:17-43)."""
    img_uvd = crop_uvd_to_image_uvd(jt_uvd, box, crop_w, crop_h)
    return uvd2xyz(img_uvd, paras) * 1000.0


def orthogonal_procrustes_np(a: np.ndarray, b: np.ndarray):
    """R, s as ``scipy.linalg.orthogonal_procrustes(b, a)`` gives them: R
    orthogonal and s the sum of the singular values of ``b.T @ a``."""
    u, w, vt = np.linalg.svd(b.T.dot(a).T)
    r = u.dot(vt)
    scale = w.sum()
    return r, scale


def align_w_scale_np(mtx1: np.ndarray, mtx2: np.ndarray, return_trafo: bool = False):
    """Similarity-align ``mtx2`` (pred) to ``mtx1`` (GT) — freihand/eval.py:71-94."""
    t1 = mtx1.mean(0)
    t2 = mtx2.mean(0)
    mtx1_t = mtx1 - t1
    mtx2_t = mtx2 - t2

    s1 = np.linalg.norm(mtx1_t) + 1e-8
    mtx1_t = mtx1_t / s1
    s2 = np.linalg.norm(mtx2_t) + 1e-8
    mtx2_t = mtx2_t / s2

    r, s = orthogonal_procrustes_np(mtx1_t, mtx2_t)
    mtx2_t = np.dot(mtx2_t, r.T) * s
    mtx2_t = mtx2_t * s1 + t1
    if return_trafo:
        return r, s, s1, t1 - t2
    return mtx2_t


def align_w_scale(mtx1: torch.Tensor, mtx2: torch.Tensor) -> torch.Tensor:
    """Batched Procrustes alignment with scale of ``mtx2`` (pred) to
    ``mtx1`` (GT), ``[..., N, 3]``, on the inputs' device: the whole HPE
    metric sweep as one batch instead of the reference's per-sample loop
    (hpe_eval.py:202-211; ``handnet_tpu/ops/geometry.py:102-122``)."""
    t1 = mtx1.mean(dim=-2, keepdim=True)
    t2 = mtx2.mean(dim=-2, keepdim=True)
    a = mtx1 - t1
    b = mtx2 - t2
    s1 = torch.linalg.norm(a, dim=(-2, -1), keepdim=True) + 1e-8
    s2 = torch.linalg.norm(b, dim=(-2, -1), keepdim=True) + 1e-8
    a = a / s1
    b = b / s2
    # R, s from the SVD of (b^T a)^T = a^T b
    m = torch.matmul(b.transpose(-1, -2), a).transpose(-1, -2)
    u, w, vt = torch.linalg.svd(m)
    r = torch.matmul(u, vt)
    s = w.sum(dim=-1)[..., None, None]
    out = torch.matmul(b, r.transpose(-1, -2)) * s
    return out * s1 + t1
