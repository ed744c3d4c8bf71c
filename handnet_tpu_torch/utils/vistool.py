"""Hand-skeleton visualization on images (numpy, host-side).

The port's copy of ``handnet_tpu/utils/vistool.py``. Reference:
utils/vistool.py:6-88 (per-dataset finger topologies, GT in red /
prediction in blue, circles + bones) and utils/utils.py:190-256
(vis_minibatch grid). Same topologies, same color ramps. The JAX package
draws with ``cv2.circle``/``cv2.line`` and writes with ``cv2.imwrite``; the
port uses no ``cv2``: it draws through ``utils/draw.py`` (OpenCV's
``drawing.cpp`` transcribed, pixel for pixel) and writes through
``data/image_io.imwrite`` (a ``.jpg`` byte for byte as ``cv2.imwrite``, a
``.png`` with the same pixels).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from handnet_tpu_torch.data.image_io import imwrite
from handnet_tpu_torch.utils import draw

# per-finger joint groups + bone lists, keyed by dataset topology
# (vistool.py:49-88)
_TOPOLOGIES: Dict[str, Tuple[List[List[int]], List[List[Tuple[int, int]]]]] = {
    "dexycb": (
        [[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12], [13, 14, 15, 16],
         [17, 18, 19, 20, 0]],
        [[(0, 1), (1, 2), (2, 3), (3, 4)],
         [(0, 5), (5, 6), (6, 7), (7, 8)],
         [(0, 9), (9, 10), (10, 11), (11, 12)],
         [(0, 13), (13, 14), (14, 15), (15, 16)],
         [(0, 17), (17, 18), (18, 19), (19, 20)]],
    ),
    "nyu": (
        [[0, 1], [2, 3], [4, 5], [6, 7], [8, 9, 10, 11, 12, 13]],
        [[(0, 1), (1, 13)], [(2, 3), (3, 13)], [(4, 5), (5, 13)],
         [(6, 7), (7, 13)],
         [(8, 9), (9, 10), (10, 13), (11, 13), (12, 13)]],
    ),
    "icvl": (
        [[1, 2, 3], [4, 5, 6], [7, 8, 9], [10, 11, 12], [13, 14, 15, 0]],
        [[(0, 1), (1, 2), (2, 3)], [(0, 4), (4, 5), (5, 6)],
         [(0, 7), (7, 8), (8, 9)], [(0, 10), (10, 11), (11, 12)],
         [(0, 13), (13, 14), (14, 15)]],
    ),
    "hands": (
        [[1, 6, 7, 8], [2, 9, 10, 11], [3, 12, 13, 14], [4, 15, 16, 17],
         [5, 18, 19, 20, 0]],
        [[(0, 1), (1, 6), (6, 7), (7, 8)],
         [(0, 2), (2, 9), (9, 10), (10, 11)],
         [(0, 3), (3, 12), (12, 13), (13, 14)],
         [(0, 4), (4, 15), (15, 16), (16, 17)],
         [(0, 5), (5, 18), (18, 19), (19, 20)]],
    ),
}
_TOPOLOGIES["msra"] = _TOPOLOGIES["dexycb"]

# BGR finger color ramps (vistool.py:10-15)
COLOR_GT = [(0, 0, 102), (0, 0, 179), (0, 0, 255), (77, 77, 255),
            (153, 153, 255)]
COLOR_PRED = [(102, 0, 0), (179, 0, 0), (255, 0, 0), (255, 77, 77),
              (255, 153, 153)]


class VisualUtil:
    """Skeleton renderer (same constructor/plot contract as the reference)."""

    def __init__(self, dataset: str = "dexycb"):
        key = dataset if dataset in _TOPOLOGIES else (
            "hands" if "hands" in dataset else "dexycb")
        self.dataset = dataset
        self.jt_idx, self.sketch = _TOPOLOGIES[key]

    def orig_depth(self, img: np.ndarray) -> np.ndarray:
        image = (np.squeeze(img.copy()) + 1) * 100
        return np.repeat(image[:, :, None], 3, axis=-1)

    def plot(self, img: np.ndarray, path: Optional[str],
             jt_uvd_gt: Optional[np.ndarray],
             jt_uvd_pred: Optional[np.ndarray] = None,
             return_image: bool = False):
        image = np.ascontiguousarray(img.copy())
        if isinstance(jt_uvd_pred, np.ndarray):
            self._plot_fingers(image, jt_uvd_pred.reshape(-1, 3), COLOR_PRED)
        if isinstance(jt_uvd_gt, np.ndarray):
            self._plot_fingers(image, jt_uvd_gt.reshape(-1, 3), COLOR_GT)
        if return_image or path is None:
            return image
        imwrite(path, image)
        return True

    def _plot_fingers(self, img, jt_uvd, colors):
        for i, color in enumerate(colors):
            for idx in self.jt_idx[i]:
                draw.circle(img, (int(jt_uvd[idx][0]), int(jt_uvd[idx][1])),
                            2, color, -1)
            for s, e in self.sketch[i]:
                draw.line(img, (int(jt_uvd[s][0]), int(jt_uvd[s][1])),
                          (int(jt_uvd[e][0]), int(jt_uvd[e][1])), color, 1)


def vis_minibatch(color_ims: np.ndarray, depth_ims: np.ndarray,
                  jt_uvd_gt: np.ndarray, vistool: VisualUtil,
                  ids: Optional[np.ndarray] = None, path: Optional[str] = None,
                  jt_pred: Optional[np.ndarray] = None) -> np.ndarray:
    """Batch grid of depth crops with skeleton overlays — the wandb-image
    logger input (utils/utils.py:190-256 equivalent, cols of 4)."""
    b = depth_ims.shape[0]
    tiles = []
    for i in range(b):
        depth = np.squeeze(depth_ims[i])
        vis = np.clip(depth * 255 / max(depth.max(), 1e-6), 0,
                      255).astype(np.uint8)
        vis = np.repeat(vis[:, :, None], 3, axis=-1)
        gt = jt_uvd_gt[i] if jt_uvd_gt is not None else None
        pred = jt_pred[i] if jt_pred is not None else None
        tiles.append(vistool.plot(vis, None, gt, pred, return_image=True))
    cols = min(4, b)
    rows = -(-b // cols)
    h, w = tiles[0].shape[:2]
    grid = np.zeros((rows * h, cols * w, 3), np.uint8)
    for i, tile in enumerate(tiles):
        r, c = divmod(i, cols)
        grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = tile
    if path is not None:
        imwrite(path, grid)
    return grid
