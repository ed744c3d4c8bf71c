"""Image augmentation: colour jitter (host-side numpy).

A copy of ``handnet_tpu/data/imgtrans.py`` (reference datasets3d/
imgtrans.py:30-53): random brightness, contrast, saturation and hue applied
in shuffled order, on float RGB arrays in [0, 1] (no PIL or torchvision),
with the same parameter semantics (factor ~ U[max(0, 1-x), 1+x], hue shift
~ U[-h, h]). The draws and their order on ``rng`` are the JAX package's, so
one ``np.random.default_rng(seed)`` gives the same image bit for bit.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def adjust_brightness(img: np.ndarray, factor: float) -> np.ndarray:
    return np.clip(img * factor, 0.0, 1.0)


def adjust_contrast(img: np.ndarray, factor: float) -> np.ndarray:
    # grayscale mean pivot (ITU-R 601-2 luma, the PIL convention)
    gray = (0.299 * img[..., 0] + 0.587 * img[..., 1]
            + 0.114 * img[..., 2]).mean()
    return np.clip((img - gray) * factor + gray, 0.0, 1.0)


def adjust_saturation(img: np.ndarray, factor: float) -> np.ndarray:
    gray = (0.299 * img[..., 0] + 0.587 * img[..., 1]
            + 0.114 * img[..., 2])[..., None]
    return np.clip((img - gray) * factor + gray, 0.0, 1.0)


def _rgb_to_hsv(img):
    mx = img.max(-1)
    mn = img.min(-1)
    diff = mx - mn + 1e-12
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    h = np.where(mx == r, (g - b) / diff % 6,
                 np.where(mx == g, (b - r) / diff + 2, (r - g) / diff + 4))
    h = h / 6.0
    s = np.where(mx > 0, diff / (mx + 1e-12), 0.0)
    return h, s, mx


def _hsv_to_rgb(h, s, v):
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    i = i.astype(int) % 6
    out = np.zeros(h.shape + (3,), np.float32)
    for idx, (rr, gg, bb) in enumerate(((v, t, p), (q, v, p), (p, v, t),
                                        (p, q, v), (t, p, v), (v, p, q))):
        mask = i == idx
        out[..., 0][mask] = rr[mask]
        out[..., 1][mask] = gg[mask]
        out[..., 2][mask] = bb[mask]
    return out


def adjust_hue(img: np.ndarray, shift: float) -> np.ndarray:
    h, s, v = _rgb_to_hsv(img)
    return np.clip(_hsv_to_rgb((h + shift) % 1.0, s, v), 0.0, 1.0)


def color_jitter(img: np.ndarray, brightness: float = 0, contrast: float = 0,
                 saturation: float = 0, hue: float = 0,
                 rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Random jitter in shuffled order (imgtrans.py:30-53). img float 0-1."""
    rng = rng or np.random.default_rng()
    ops = []
    if brightness > 0:
        f = rng.uniform(max(0, 1 - brightness), 1 + brightness)
        ops.append(lambda x: adjust_brightness(x, f))
    if contrast > 0:
        f = rng.uniform(max(0, 1 - contrast), 1 + contrast)
        ops.append(lambda x: adjust_contrast(x, f))
    if saturation > 0:
        f = rng.uniform(max(0, 1 - saturation), 1 + saturation)
        ops.append(lambda x: adjust_saturation(x, f))
    if hue > 0:
        f = rng.uniform(-hue, hue)
        ops.append(lambda x: adjust_hue(x, f))
    order = rng.permutation(len(ops))
    out = img.astype(np.float32)
    for i in order:
        out = ops[i](out)
    return out
