"""Host-side mesh/skeleton visualization without a GL stack.

The port's copy of ``handnet_tpu/utils/meshvis.py``, without ``cv2``: the
wireframe is drawn through ``utils/draw.py`` (``cv2.polylines``
transcribed, pixel for pixel) and the colour map is OpenCV's
``COLORMAP_JET`` lookup table, written out below (what
``cv2.applyColorMap`` gives for each of the 256 inputs). matplotlib is
imported inside the figure helpers only, as the JAX package does.

Reference equivalents: utils/visualize/displaymano.py (matplotlib hand mesh
plots) and the pyrender offscreen path of ros_demo.py:51-128. We provide:

* ``project_mesh`` — camera projection of mesh vertices,
* ``draw_mesh_wireframe`` — polyline rendering of the projected faces,
* ``depth_colormap`` — depth image to displayable color map,
* ``visualize_hand_batch`` / ``add_mesh_3d`` / ``add_joints_3d`` — the
  matplotlib grid + 3-D mesh/skeleton display (displaymano.py:15-283).

GL windows stay out of scope (no GL in the image); shaded *software*
rendering lives in utils/raster.py.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from handnet_tpu_torch.utils import draw

# OpenCV's COLORMAP_JET (imgproc/src/colormap.cpp, ``Jet``) as the 256-entry
# BGR table cv2.applyColorMap reads: 256 bytes of B, then of G, then of R
_JET_HEX = (
    # B
    "8084888c9094989ca0a4a8acb0b4b8bcc0c4c8ccd0d4d8dce0e4e8ecf0f4f8fc"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "fefaf6f2eeeae6e2dedad6d2cecac6c2bebab6b2aeaaa6a29e9a96928e8a8682"
    "7e7a76726e6a66625e5a56524e4a46423e3a36322e2a26221e1a16120e0a0601"
    "0000000000000000000000000000000000000000000000000000000000000000"
    "0000000000000000000000000000000000000000000000000000000000000000"
    "0000000000000000000000000000000000000000000000000000000000000000"
    # G
    "0000000000000000000000000000000000000000000000000000000000000000"
    "0004080c1014181c2024282c3034383c4044484c5054585c6064686c7074787c"
    "8084888c9094989ca0a4a8acb0b4b8bcc0c4c8ccd0d4d8dce0e4e8ecf0f4f8fc"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "fcf8f4f0ece8e4e0dcd8d4d0ccc8c4c0bcb8b4b0aca8a4a09c9894908c888480"
    "7c7874706c6864605c5854504c4844403c3834302c2824201c1814100c080400"
    "0000000000000000000000000000000000000000000000000000000000000000"
    # R
    "0000000000000000000000000000000000000000000000000000000000000000"
    "0000000000000000000000000000000000000000000000000000000000000000"
    "0000000000000000000000000000000000000000000000000000000000000000"
    "02060a0e12161a1e22262a2e32363a3e42464a4e52565a5e62666a6e72767a7e"
    "82868a8e92969a9ea2a6aaaeb2b6babec2c6caced2d6dadee2e6eaeef2f6fafe"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "fcf8f4f0ece8e4e0dcd8d4d0ccc8c4c0bcb8b4b0aca8a4a09c9894908c888480")
JET_LUT = np.ascontiguousarray(np.frombuffer(bytes.fromhex(_JET_HEX), np.uint8)
                               .reshape(3, 256).T)


def project_mesh(verts_mm: np.ndarray, paras: np.ndarray) -> np.ndarray:
    """[V, 3] mm camera-frame -> [V, 2] pixels."""
    v = verts_mm / 1000.0
    u = v[:, 0] * paras[0] / np.maximum(v[:, 2], 1e-6) + paras[2]
    w = v[:, 1] * paras[1] / np.maximum(v[:, 2], 1e-6) + paras[3]
    return np.stack([u, w], axis=1)


def draw_mesh_wireframe(image: np.ndarray, verts_mm: np.ndarray,
                        faces: np.ndarray, paras: np.ndarray,
                        color: Tuple[int, int, int] = (0, 200, 0),
                        max_faces: int = 600) -> np.ndarray:
    """Overlay a wireframe of (subsampled) mesh faces on a BGR image."""
    out = np.ascontiguousarray(image.copy())
    uv = project_mesh(verts_mm, paras).astype(np.int32)
    h, w = image.shape[:2]
    step = max(1, len(faces) // max_faces)
    for f in faces[::step]:
        pts = uv[f]
        if ((pts[:, 0] < 0) | (pts[:, 0] >= w)
                | (pts[:, 1] < 0) | (pts[:, 1] >= h)).any():
            continue
        draw.polylines(out, pts, True, color, 1)
    return out


def depth_colormap(depth_m: np.ndarray, max_depth: float = 2.0) -> np.ndarray:
    """Depth in meters -> BGR colormap image (``cv2.applyColorMap(...,
    cv2.COLORMAP_JET)``: a table lookup)."""
    norm = np.clip(depth_m / max_depth, 0, 1)
    return JET_LUT[(norm * 255).astype(np.uint8)]


# ---------------------------------------------------------------------------
# matplotlib 3-D hand display — the displaymano equivalent
# (reference utils/visualize/displaymano.py:15-283: visualize_batch grid,
# add_mesh Poly3DCollection, add_joints_proj, cam_equal_aspect_3d). Used for
# offline inspection / report figures; Agg-safe (no display needed).
# ---------------------------------------------------------------------------

def equal_aspect_3d(ax, pts: np.ndarray) -> None:
    """Center the 3-D axes on the points' bounding cube with equal aspect,
    flipping y/z so the camera convention (y down, z forward) reads
    naturally (displaymano.py:264-283 semantics)."""
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    c = (lo + hi) / 2.0
    r = float((hi - lo).max()) / 2.0 or 1.0
    ax.set_xlim(c[0] - r, c[0] + r)
    ax.set_ylim(c[1] + r, c[1] - r)
    ax.set_zlim(c[2] + r, c[2] - r)


def add_mesh_3d(ax, verts: np.ndarray, faces: np.ndarray,
                face_color=(0.55, 0.72, 0.89), edge_color=(0.0, 0.0, 0.44),
                alpha: float = 1.0) -> None:
    """Add a triangle mesh to a 3-D axes (displaymano.py:236-261 role)."""
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    coll = Poly3DCollection(verts[faces], alpha=alpha)
    coll.set_facecolor(face_color)
    coll.set_edgecolor(edge_color)
    ax.add_collection3d(coll)
    ax.view_init(elev=90, azim=-90)
    equal_aspect_3d(ax, verts)


def add_joints_3d(ax, joints: np.ndarray, dataset: str = "dexycb",
                  pred: bool = False) -> None:
    """Draw a 3-D hand skeleton using the per-finger topology/colors shared
    with the 2-D VisualUtil (vistool topologies; displaymano joint rows)."""
    from handnet_tpu_torch.utils.vistool import (COLOR_GT, COLOR_PRED, _TOPOLOGIES)

    key = dataset if dataset in _TOPOLOGIES else "dexycb"
    jt_idx, sketch = _TOPOLOGIES[key]
    ramp = COLOR_PRED if pred else COLOR_GT
    for finger, (b, g, r) in zip(range(len(jt_idx)), ramp):
        color = (r / 255.0, g / 255.0, b / 255.0)
        idx = jt_idx[finger]
        ax.scatter(joints[idx, 0], joints[idx, 1], joints[idx, 2],
                   color=color, s=8)
        for s, e in sketch[finger]:
            seg = joints[[s, e]]
            ax.plot(seg[:, 0], seg[:, 1], seg[:, 2], color=color,
                    linewidth=1.0)


def visualize_hand_batch(save_path: Optional[str],
                         images: Optional[np.ndarray] = None,
                         joints2d_gt: Optional[np.ndarray] = None,
                         joints2d_pred: Optional[np.ndarray] = None,
                         joints3d_gt: Optional[np.ndarray] = None,
                         joints3d_pred: Optional[np.ndarray] = None,
                         verts3d: Optional[np.ndarray] = None,
                         faces: Optional[np.ndarray] = None,
                         max_rows: int = 4, dataset: str = "dexycb"):
    """Save a row-per-sample grid figure: input image + 2-D joints | 3-D
    skeletons | 3-D mesh (the displaymano.py:15-196 visualize_batch
    artifact, rebuilt on the framework's batch conventions: leading batch
    axis, NHWC float images, [B,J,2]/[B,J,3] joints, [B,V,3] verts).

    Any column whose inputs are ``None`` is dropped. Returns the figure
    (also saved to ``save_path`` when given; use the Agg backend headless).
    """
    import matplotlib
    if save_path is not None:
        matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    arrays = [a for a in (images, joints2d_gt, joints2d_pred, joints3d_gt,
                          joints3d_pred, verts3d) if a is not None]
    if not arrays:
        raise ValueError("nothing to draw")
    rows = min(min(a.shape[0] for a in arrays), max_rows)
    cols = ((images is not None or joints2d_gt is not None
             or joints2d_pred is not None)
            + (joints3d_gt is not None or joints3d_pred is not None)
            + (verts3d is not None and faces is not None))
    fig = plt.figure(figsize=(3 * cols, 3 * rows))
    for row in range(rows):
        col = 1
        if (images is not None or joints2d_gt is not None
                or joints2d_pred is not None):
            ax = fig.add_subplot(rows, cols, row * cols + col)
            if images is not None:
                ax.imshow(np.clip(images[row], 0, 1))
            for j2, pred in ((joints2d_gt, False), (joints2d_pred, True)):
                if j2 is not None:
                    ax.scatter(j2[row, :, 0], j2[row, :, 1], s=4,
                               c="r" if not pred else "b")
            ax.axis("off")
            col += 1
        if joints3d_gt is not None or joints3d_pred is not None:
            ax = fig.add_subplot(rows, cols, row * cols + col,
                                 projection="3d")
            ref = joints3d_gt if joints3d_gt is not None else joints3d_pred
            if joints3d_gt is not None:
                add_joints_3d(ax, joints3d_gt[row], dataset, pred=False)
            if joints3d_pred is not None:
                add_joints_3d(ax, joints3d_pred[row], dataset, pred=True)
            equal_aspect_3d(ax, ref[row])
            col += 1
        if verts3d is not None and faces is not None:
            ax = fig.add_subplot(rows, cols, row * cols + col,
                                 projection="3d")
            add_mesh_3d(ax, verts3d[row], faces)
            col += 1
    fig.tight_layout()
    if save_path is not None:
        fig.savefig(save_path, dpi=80)
        plt.close(fig)
    return fig
