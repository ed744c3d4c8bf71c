"""A2J training-sample construction: DexYCB frame -> (depth crop, UVD labels).

The port's copy of ``handnet_tpu/data/a2j_data.py``, in numpy alone: the
depth PNG is read with ``data/image_io.py`` and the two resamplers are
written out here instead of calling ``cv2``.

Reference: datasets3d/a2jdataset.py:204-293 —
  seg(255) -> RLE -> bbox -> +30% pad (:213-230), consistent-direction random
  crop shift + random +-180deg rotation about the crop center (:234-260),
  nearest-neighbor crop resize to 176^2 (:267-271), UVD labels from
  camera-frame joints via xyz2uvd mapped into the crop (:278-287).

The resamplers are ``cv2``'s, as the reference calls them and as the JAX
package calls them wherever ``cv2`` is installed:

* :func:`resize_nearest` is ``cv2.resize(..., INTER_NEAREST)``: source
  index ``floor(i * (1 / (out / in)))`` in float64. (The integer form
  ``i * in // out``, the JAX package's fallback without ``cv2``, picks
  another pixel for some sizes.)
* :func:`warp_affine_bilinear` is OpenCV 4's ``cv2.warpAffine(img, m, (w,
  h))`` at its defaults: bilinear, a constant 0 border, the inverse map,
  each source coordinate in fixed point on a 1/32-pixel grid. OpenCV 5
  computes the coordinate in floating point instead, so its samples lie
  up to 1/64 pixel away on each axis: up to 1/32 of the largest step
  between neighbouring pixels (centimetres at a hand's edge).

:class:`A2JDataSource` shares one ``numpy`` Generator across the loader's
threads, as the JAX package does: with one worker the draws follow JAX's
exactly; with more, their order follows the threads' scheduling.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from handnet_tpu_torch.data import image_io
from handnet_tpu_torch.data import rle as rle_mod
from handnet_tpu_torch.data.dexycb import HAND_SEG_LABEL, paras_from_intrinsics


def xyz2uvd_np(pts: np.ndarray, paras: np.ndarray) -> np.ndarray:
    out = pts.reshape(-1, 3).copy()
    out[:, :2] = out[:, :2] * paras[:2] / out[:, 2:] + paras[2:]
    return out.astype(np.float32)


def hand_bbox_from_seg(seg: np.ndarray, pad_percent: float = 0.3
                       ) -> Optional[np.ndarray]:
    """seg -> padded xyxy hand box (a2jdataset.py:213-230)."""
    mask = seg == HAND_SEG_LABEL
    if not mask.any():
        return None
    r = rle_mod.encode(np.asfortranarray(mask).astype(np.uint8))
    x, y, w, h = rle_mod.toBbox(r)
    bbox = np.array([x, y, x + w, y + h], np.float64)
    bw = bbox[2] - bbox[0]
    bh = bbox[3] - bbox[1]
    bbox[0] = max(0, bbox[0] - pad_percent * bw)
    bbox[1] = max(0, bbox[1] - pad_percent * bh)
    bbox[2] = min(seg.shape[1], bbox[2] + pad_percent * bw)
    bbox[3] = min(seg.shape[0], bbox[3] + pad_percent * bh)
    return bbox


def resize_nearest(img: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """``cv2.resize(img, (out_w, out_h), interpolation=cv2.INTER_NEAREST)``."""
    h, w = img.shape[:2]
    ys = np.minimum(np.floor(np.arange(out_h) * (1.0 / (out_h / h))).astype(np.int64), h - 1)
    xs = np.minimum(np.floor(np.arange(out_w) * (1.0 / (out_w / w))).astype(np.int64), w - 1)
    return img[ys[:, None], xs[None, :]]


# OpenCV 4's warpAffine fixed point: products in 1/2**10 (AB_BITS), samples
# on a 1/32-pixel grid (INTER_BITS), rounded by half a grid step
_AB_BITS, _INTER_BITS = 10, 5
_AB_SCALE, _INTER_TAB = 1 << _AB_BITS, 1 << _INTER_BITS
_AB_HALF_STEP = _AB_SCALE // _INTER_TAB // 2


def _rotation_matrix(cx: float, cy: float, angle_deg: float) -> np.ndarray:
    """cv2.getRotationMatrix2D equivalent (rotation about (cx, cy), scale 1)."""
    a = np.deg2rad(angle_deg)
    cos, sin = np.cos(a), np.sin(a)
    return np.array([[cos, sin, (1 - cos) * cx - sin * cy],
                     [-sin, cos, sin * cx + (1 - cos) * cy]], np.float64)


def warp_affine_bilinear(img: np.ndarray, m: np.ndarray, out_w: int,
                         out_h: int) -> np.ndarray:
    """``cv2.warpAffine(img, m, (out_w, out_h))`` of OpenCV 4 for a float32
    ``[H, W]`` or ``[H, W, C]`` image: each output pixel (x, y) samples the
    source at ``m``'s inverse applied to (x, y), bilinearly, with the
    pixels outside the image read as 0. As in OpenCV 4's WarpAffineInvoker
    the inverse map's products are taken in 10-bit fixed point (rounded
    half to even) plus half a grid step, and shifted to a 1/32-pixel grid
    (``INTER_BITS``); the weights are its float32 table's."""
    a, b, c = m[0]
    d, e, f = m[1]
    det = a * e - b * d
    det = 1.0 / det if det != 0 else 0.0
    inv = np.array([[e * det, -b * det, 0.0], [-d * det, a * det, 0.0]])
    inv[0, 2] = -inv[0, 0] * c - inv[0, 1] * f
    inv[1, 2] = -inv[1, 0] * c - inv[1, 1] * f
    xs, ys = np.arange(out_w, dtype=np.float64), np.arange(out_h, dtype=np.float64)
    grid = []
    for row in inv:
        across = np.rint(row[0] * xs * _AB_SCALE).astype(np.int64)
        down = np.rint((row[1] * ys + row[2]) * _AB_SCALE).astype(np.int64) + _AB_HALF_STEP
        grid.append((down[:, None] + across[None, :]) >> (_AB_BITS - _INTER_BITS))
    x0, y0 = (g >> _INTER_BITS for g in grid)
    fx, fy = (((g & (_INTER_TAB - 1)).astype(np.float32) * np.float32(1.0 / _INTER_TAB))[..., None]
              for g in grid)
    h, w = img.shape[:2]
    src = img.reshape(h, w, -1).astype(np.float32)
    # one pixel of zeros around the image: every neighbour outside reads 0
    padded = np.zeros((h + 2, w + 2, src.shape[2]), np.float32)
    padded[1:-1, 1:-1] = src

    def tap(yy, xx):
        inside = (xx >= -1) & (xx <= w) & (yy >= -1) & (yy <= h)
        v = padded[np.clip(yy, -1, h) + 1, np.clip(xx, -1, w) + 1]
        return np.where(inside[..., None], v, np.float32(0))

    one = np.float32(1)
    out = (tap(y0, x0) * ((one - fy) * (one - fx)) + tap(y0, x0 + 1) * ((one - fy) * fx)
           + tap(y0 + 1, x0) * (fy * (one - fx)) + tap(y0 + 1, x0 + 1) * (fy * fx))
    return out.reshape((out_h, out_w) + img.shape[2:]).astype(np.float32)


@dataclass(frozen=True)
class A2JSampleConfig:
    crop_w: int = 176
    crop_h: int = 176
    num_joints: int = 21
    bbox_pad: float = 0.3
    rand_rotate: float = 180.0
    rand_shift_frac: float = 0.1
    # random box-scale jitter about the center: robustness to detector-box
    # framing at inference (the reference declares RandScale=(1.0, 0.5) at
    # a2jdataset.py:71 but never applies it; 0 disables)
    rand_scale_frac: float = 0.0


def build_a2j_sample(depth_m: np.ndarray, seg: np.ndarray,
                     joints_xyz_m: np.ndarray, paras: np.ndarray,
                     color: Optional[np.ndarray] = None,
                     augment: bool = False,
                     rng: Optional[np.random.Generator] = None,
                     cfg: A2JSampleConfig = A2JSampleConfig()
                     ) -> Optional[Dict[str, np.ndarray]]:
    """One A2J sample. depth in meters [H, W], joints in meters [21, 3].

    Returns dict(depth [H', W', 1], jt_uvd [21, 3], box xyxy [4], paras [4],
    color [H', W', 3] if given, rgbd [H', W', 4] if color given) or None when
    no hand pixels exist. The random draws are the JAX package's, in its
    order.
    """
    bbox = hand_bbox_from_seg(seg, cfg.bbox_pad)
    if bbox is None:
        return None
    rng = rng or np.random.default_rng()

    if augment and cfg.rand_scale_frac > 0:
        s = float(rng.uniform(1.0 - cfg.rand_scale_frac,
                              1.0 + cfg.rand_scale_frac))
        cx, cy = (bbox[0] + bbox[2]) / 2.0, (bbox[1] + bbox[3]) / 2.0
        hw = (bbox[2] - bbox[0]) / 2.0 * s
        hh = (bbox[3] - bbox[1]) / 2.0 * s
        bbox = np.array([cx - hw, cy - hh, cx + hw, cy + hh])

    if augment:
        w = bbox[2] - bbox[0]
        h = bbox[3] - bbox[1]
        sx = int(0.1 * w // 1)
        sy = int(0.1 * h // 1)
        o1 = int(rng.integers(-sx, sx)) if sx > 0 else 0
        o2 = int(rng.integers(-sy, sy)) if sy > 0 else 0
        o3 = int(rng.integers(-sx, sx)) if sx > 0 else 0
        o4 = int(rng.integers(-sy, sy)) if sy > 0 else 0
        # keep the shift direction consistent (a2jdataset.py:245-248)
        if (o1 > 0 > o3) or (o1 < 0 < o3):
            o1 = -o1
        if (o2 > 0 > o4) or (o2 < 0 < o4):
            o2 = -o2
        angle = (float(rng.integers(-cfg.rand_rotate, cfg.rand_rotate))
                 if cfg.rand_rotate > 0 else 0.0)
    else:
        o1 = o2 = o3 = o4 = 0
        angle = 0.0

    H, W = depth_m.shape
    x1 = max(bbox[0] + o1, 0)
    y1 = max(bbox[1] + o2, 0)
    x2 = min(bbox[2] + o3, W - 1)
    y2 = min(bbox[3] + o4, H - 1)
    if int(x2) - int(x1) < 2 or int(y2) - int(y1) < 2:
        return None

    crop = depth_m[int(y1):int(y2), int(x1):int(x2)]
    crop = resize_nearest(crop.astype(np.float32), cfg.crop_w, cfg.crop_h)

    uvd_full = xyz2uvd_np(joints_xyz_m, paras)
    jt = np.empty((cfg.num_joints, 3), np.float32)
    jt[:, 0] = (uvd_full[:, 0] - x1) * cfg.crop_w / (x2 - x1)
    jt[:, 1] = (uvd_full[:, 1] - y1) * cfg.crop_h / (y2 - y1)
    jt[:, 2] = uvd_full[:, 2]

    out: Dict[str, np.ndarray] = {}
    if augment and angle != 0.0:
        m = _rotation_matrix(cfg.crop_w / 2.0, cfg.crop_h / 2.0, angle)
        crop = warp_affine_bilinear(crop, m, cfg.crop_w, cfg.crop_h)
        pts = np.concatenate([jt[:, :2], np.ones((cfg.num_joints, 1))], axis=1)
        jt[:, :2] = (m @ pts.T).T

    out["depth"] = crop[..., None].astype(np.float32)
    out["jt_uvd"] = jt
    out["box"] = np.array([x1, y1, x2, y2], np.float32)
    out["paras"] = np.asarray(paras, np.float32)

    if color is not None:
        ccrop = color[int(y1):int(y2), int(x1):int(x2)]
        ccrop = resize_nearest(ccrop.astype(np.float32), cfg.crop_w, cfg.crop_h)
        if augment and angle != 0.0:
            m = _rotation_matrix(cfg.crop_w / 2.0, cfg.crop_h / 2.0, angle)
            ccrop = warp_affine_bilinear(ccrop, m, cfg.crop_w, cfg.crop_h)
        out["color"] = ccrop / 255.0
        out["rgbd"] = np.concatenate([out["color"], out["depth"]],
                                     axis=-1).astype(np.float32)
    return out


class A2JDataSource:
    """Indexable DexYCB -> A2J sample source for the prefetch loader.

    Mirrors A2JDataset (a2jdataset.py:42-303) minus the torch plumbing:
    refined indices in, fixed-shape numpy dicts out; broken samples resample
    a random index (:295-303). ``with_color=True`` (RGB-D) adds the colour
    crop (``color``, and ``rgbd`` = colour then depth) from the frame as
    ``imread_color`` decodes it: BGR, as the JAX package's ``cv2.imread``
    gives it, with no flip to RGB (its detector data flips; this does not).
    """

    def __init__(self, dataset, refined_idx, augment: bool,
                 cfg: A2JSampleConfig = A2JSampleConfig(), seed: int = 0,
                 with_color: bool = False):
        self.dataset = dataset
        self.refined_idx = list(refined_idx)
        self.augment = augment
        self.cfg = cfg
        self.with_color = with_color
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.refined_idx)

    def _load(self, idx: int) -> Optional[Dict[str, np.ndarray]]:
        sample = self.dataset[self.refined_idx[idx]]
        try:
            depth = image_io.read_png(sample["depth_file"])
        except FileNotFoundError:
            return None   # cv2.imread returns None, and the JAX package resamples
        depth = depth.astype(np.float32) / 1000.0
        label = np.load(sample["label_file"])
        j3d = label["joint_3d"].reshape(21, 3)
        if np.all(j3d == -1):
            return None
        color = (image_io.imread_color(sample["color_file"])
                 if self.with_color else None)
        paras = paras_from_intrinsics(sample["intrinsics"])
        out = build_a2j_sample(depth, label["seg"], j3d, paras, color=color,
                               augment=self.augment, rng=self._rng,
                               cfg=self.cfg)
        if out is not None:
            out["dexycb_id"] = np.asarray([self.refined_idx[idx]], np.int64)
        return out

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        out = self._load(idx)
        tries = 0
        while out is None and tries < 10:
            out = self._load(int(self._rng.integers(0, len(self))))
            tries += 1
        if out is None:
            raise RuntimeError(f"could not load a valid sample near idx {idx}")
        return out
