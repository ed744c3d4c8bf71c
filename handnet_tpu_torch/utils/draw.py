"""OpenCV's thin-line and filled-circle drawing, in numpy, without ``cv2``.

The port draws skeletons (``utils/vistool.py``) and mesh wireframes
(``utils/meshvis.py``) as the JAX package does with ``cv2.line``,
``cv2.circle`` and ``cv2.polylines``, pixel for pixel. This module
transcribes the cases those callers use from OpenCV's
``modules/imgproc/src/drawing.cpp`` (4.x and 5.x draw them alike):

* :func:`line`: ``cv2.line(img, p1, p2, color, 1)`` (``LINE_8``, shift 0):
  ``ThickLine`` at thickness 1 calls ``Line``, which walks
  ``LineIterator`` with 8-connectivity from the left end point, after
  ``clipLine`` has clipped the segment to the image when an end point
  lies outside it;
* :func:`circle`: ``cv2.circle(img, center, r, color, -1)`` (filled,
  ``LINE_8``, shift 0): ``Circle``'s midpoint walk, one horizontal span
  per step, clipped to the image;
* :func:`polylines`: ``cv2.polylines(img, [pts], True, color, 1)``: a
  line from each point to the next and from the last back to the first.

Every function draws into ``img`` (``uint8 [H, W]`` or ``[H, W, C]``, C-
contiguous) in place, as OpenCV does, and returns it. ``color`` gives one
value per channel. Points are integer pixel coordinates ``(x, y)``; a
float is truncated toward zero first, as ``int()`` does in the JAX
package's calls.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

Point = Tuple[int, int]


def _color(img: np.ndarray, color) -> np.ndarray:
    channels = 1 if img.ndim == 2 else img.shape[2]
    c = np.asarray(color, np.float64).reshape(-1)
    if c.size < channels:
        c = np.concatenate([c, np.zeros(channels - c.size)])
    # scalarToRawData: saturate_cast<uchar>(cvRound(v))
    return np.clip(np.rint(c[:channels]), 0, 255).astype(np.uint8)


def clip_line(width: int, height: int, p1: Point, p2: Point):
    """``cv::clipLine(Size2l(width, height), pt1, pt2)``: the segment clipped
    to ``[0, width-1] x [0, height-1]`` as ``(inside, p1, p2)``; the
    intersections are truncated toward zero as the C++ casts do."""
    right, bottom = width - 1, height - 1
    if width <= 0 or height <= 0:
        return False, p1, p2
    x1, y1 = p1
    x2, y2 = p2
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, (x1, y1), (x2, y2)


def line_points(width: int, height: int, p1: Point, p2: Point) -> np.ndarray:
    """The pixels ``LineIterator(img, p1, p2, 8, leftToRight=true)`` visits,
    ``[count, 2]`` of ``(x, y)``, in its order."""
    p1 = (int(p1[0]), int(p1[1]))
    p2 = (int(p2[0]), int(p2[1]))
    if not (0 <= p1[0] < width and 0 <= p2[0] < width
            and 0 <= p1[1] < height and 0 <= p2[1] < height):
        inside, p1, p2 = clip_line(width, height, p1, p2)
        if not inside:
            return np.zeros((0, 2), np.int64)
    dx, dy = p2[0] - p1[0], p2[1] - p1[1]
    step_x, step_y = 1, 1
    if dx < 0:                       # leftToRight: start from the left end
        dx, dy = -dx, -dy
        p1, p2 = p2, p1
    if dy < 0:
        dy, step_y = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
        step_x, step_y = step_y, step_x
    # dx is the major axis's length. The iterator starts at err = dx - 2dy
    # and at each step takes a minor step where err < 0, then adds -2dy (and
    # 2dx after a minor step). err stays in [-2dy, 2dx - 2dy), so after k+1
    # steps the minor steps taken are ceil((2dy k - dx + 2dy) / 2dx).
    count = dx + 1
    major = np.arange(count, dtype=np.int64)
    minor = np.zeros(count, np.int64)
    minor[1:] = (2 * dy * major[:-1] + dx + 2 * dy - 1) // (2 * dx) if dx else 0
    if vert:
        xs = p1[0] + step_y * minor
        ys = p1[1] + step_x * major
    else:
        xs = p1[0] + step_x * major
        ys = p1[1] + step_y * minor
    return np.stack([xs, ys], axis=1)


def line(img: np.ndarray, p1: Point, p2: Point, color, thickness: int = 1) -> np.ndarray:
    """``cv2.line(img, p1, p2, color, thickness=1)``, ``LINE_8``."""
    if thickness != 1:
        raise ValueError(f"draw.line: thickness {thickness} (only 1 is transcribed)")
    pts = line_points(img.shape[1], img.shape[0], _trunc(p1), _trunc(p2))
    img[pts[:, 1], pts[:, 0]] = _color(img, color)
    return img


def circle(img: np.ndarray, center: Point, radius: int, color,
           thickness: int = -1) -> np.ndarray:
    """``cv2.circle(img, center, radius, color, -1)``: OpenCV's ``Circle``
    with ``fill`` set (``LINE_8``, shift 0)."""
    if thickness >= 0:
        raise ValueError(f"draw.circle: thickness {thickness} (only filled, -1, is transcribed)")
    if radius < 0:
        raise ValueError(f"draw.circle: radius {radius}")
    cx, cy = _trunc(center)
    h, w = img.shape[:2]
    col = _color(img, color)
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    inside = radius <= cx < w - radius and radius <= cy < h - radius

    def span(y, x0, x1):
        img[y, x0:x1 + 1] = col

    while dx >= dy:
        y11, y12, y21, y22 = cy - dy, cy + dy, cy - dx, cy + dx
        x11, x12, x21, x22 = cx - dx, cx + dx, cx - dy, cx + dy
        if inside:
            span(y11, x11, x12)
            span(y12, x11, x12)
            span(y21, x21, x22)
            span(y22, x21, x22)
        elif x11 < w and x12 >= 0 and y21 < h and y22 >= 0:
            x11, x12 = max(x11, 0), min(x12, w - 1)
            if 0 <= y11 < h:
                span(y11, x11, x12)
            if 0 <= y12 < h:
                span(y12, x11, x12)
            if x21 < w and x22 >= 0:
                x21, x22 = max(x21, 0), min(x22, w - 1)
                if 0 <= y21 < h:
                    span(y21, x21, x22)
                if 0 <= y22 < h:
                    span(y22, x21, x22)
        dy += 1
        err += plus
        plus += 2
        mask = (err <= 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2
    return img


def polylines(img: np.ndarray, pts: Sequence[Point], is_closed: bool, color,
              thickness: int = 1) -> np.ndarray:
    """``cv2.polylines(img, [pts], is_closed, color, 1)`` for one contour:
    ``PolyLine`` draws from the last point (closed) or the first, to each
    next one."""
    pts = np.asarray(pts).reshape(-1, 2)
    if len(pts) == 0:
        return img
    i = len(pts) - 1 if is_closed else 0
    p0 = tuple(pts[i])
    for p in pts[int(not is_closed):]:
        line(img, p0, tuple(p), color, thickness)
        p0 = tuple(p)
    return img


def _trunc(p) -> Point:
    return int(p[0]), int(p[1])
