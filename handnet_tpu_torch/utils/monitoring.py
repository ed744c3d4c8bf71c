"""Experiment monitoring: epoch metric store -> txt logs + HTML dashboards.

Reference: utils/exputils/monitoring.py:10-68 (Monitor/Metrics with plotly
HTML subplot dashboards) and utils/exputils/logutils.py:10-111 (txt epoch
logs with parse-back).

Kept dependency-light: txt logs always work; the HTML dashboard renders
with a tiny self-contained SVG writer (no plotly requirement in the image).
The port's copy of ``handnet_tpu/utils/monitoring.py``.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict, List, Optional


def create_log_file(path: str, header: str = ""):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        if header:
            f.write(header + "\n")


def log_errors(path: str, epoch: int, errors: Dict[str, float]):
    """Append one epoch line: ``epoch k1=v1 k2=v2`` (logutils.py:21-37)."""
    with open(path, "a") as f:
        kv = " ".join(f"{k}={v:.6f}" for k, v in errors.items())
        f.write(f"{epoch} {kv}\n")


def get_logs(path: str) -> Dict[str, List[float]]:
    """Parse back epoch logs (logutils.py:39-55)."""
    out: Dict[str, List[float]] = defaultdict(list)
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts or "=" not in line:
                continue
            out["epoch"].append(float(parts[0]))
            for kv in parts[1:]:
                k, v = kv.split("=")
                out[k].append(float(v))
    return dict(out)


def _svg_line_plot(xs, ys, title: str, w: int = 420, h: int = 220) -> str:
    if not xs:
        return f"<svg width='{w}' height='{h}'></svg>"
    pad = 34
    x0, x1 = min(xs), max(xs) or 1
    y0, y1 = min(ys), max(ys)
    if y1 == y0:
        y1 = y0 + 1
    sx = lambda x: pad + (x - x0) / max(x1 - x0, 1e-12) * (w - 2 * pad)
    sy = lambda y: h - pad - (y - y0) / (y1 - y0) * (h - 2 * pad)
    pts = " ".join(f"{sx(x):.1f},{sy(y):.1f}" for x, y in zip(xs, ys))
    return (
        f"<svg width='{w}' height='{h}' xmlns='http://www.w3.org/2000/svg'>"
        f"<text x='{w // 2}' y='14' text-anchor='middle' "
        f"font-size='12'>{title}</text>"
        f"<polyline fill='none' stroke='#2266cc' stroke-width='1.5' "
        f"points='{pts}'/>"
        f"<text x='{pad}' y='{h - 8}' font-size='10'>{x0:g}</text>"
        f"<text x='{w - pad}' y='{h - 8}' font-size='10' "
        f"text-anchor='end'>{x1:g}</text>"
        f"<text x='4' y='{h - pad}' font-size='10'>{y0:.3g}</text>"
        f"<text x='4' y='{pad}' font-size='10'>{y1:.3g}</text>"
        f"</svg>")


class Metrics:
    """Per-epoch metric store with save/plot (monitoring.py:31-68).
    ``write=False`` (a data-parallel rank other than 0) keeps the metrics
    and writes no file."""

    def __init__(self, checkpoint_dir: str, write: bool = True):
        self.checkpoint = checkpoint_dir
        self.write = write
        if write:
            os.makedirs(checkpoint_dir, exist_ok=True)
        self.evolution: Dict[str, Dict[int, float]] = defaultdict(dict)

    def add(self, epoch: int, values: Dict[str, float]):
        for k, v in values.items():
            self.evolution[k][epoch] = float(v)

    def save_metrics(self, path: Optional[str] = None):
        if not self.write:
            return
        path = path or os.path.join(self.checkpoint, "metrics.json")
        with open(path, "w") as f:
            json.dump({k: v for k, v in self.evolution.items()}, f, indent=1)

    def load_metrics(self, path: Optional[str] = None):
        path = path or os.path.join(self.checkpoint, "metrics.json")
        with open(path) as f:
            data = json.load(f)
        for k, v in data.items():
            self.evolution[k] = {int(e): val for e, val in v.items()}

    def plot_metrics(self, path: Optional[str] = None):
        """One HTML page, one chart per metric (the plotly-dashboard
        equivalent of monitoring.py:42-68)."""
        path = path or os.path.join(self.checkpoint, "metrics.html")
        if not self.write:
            return path
        charts = []
        for name, series in sorted(self.evolution.items()):
            epochs = sorted(series)
            charts.append(_svg_line_plot(epochs, [series[e] for e in epochs],
                                         name))
        with open(path, "w") as f:
            f.write("<html><body>" + "\n".join(charts) + "</body></html>")
        return path


def save_args(args, directory: str, name: str = "opt"):
    """Persist run arguments as txt + json (utils/exputils/argutils.py:16
    save_args equivalent — json instead of pickle)."""
    os.makedirs(directory, exist_ok=True)
    d = vars(args) if hasattr(args, "__dict__") else dict(args)
    with open(os.path.join(directory, f"{name}.txt"), "w") as f:
        for k in sorted(d):
            f.write(f"{k}: {d[k]}\n")
    with open(os.path.join(directory, f"{name}.json"), "w") as f:
        json.dump({k: repr(v) for k, v in d.items()}, f, indent=1)


class Monitor:
    """Train/val log files + Metrics (monitoring.py:10-29). ``write=False``
    (a data-parallel rank other than 0) writes no file: only rank 0 logs."""

    def __init__(self, checkpoint_dir: str, write: bool = True):
        self.checkpoint = checkpoint_dir
        self.write = write
        if write:
            os.makedirs(checkpoint_dir, exist_ok=True)
        self.train_log = os.path.join(checkpoint_dir, "train.txt")
        self.val_log = os.path.join(checkpoint_dir, "val.txt")
        self.metrics = Metrics(checkpoint_dir, write)

    def log_train(self, epoch: int, errors: Dict[str, float]):
        if self.write:
            log_errors(self.train_log, epoch, errors)
        self.metrics.add(epoch, {f"train_{k}": v for k, v in errors.items()})

    def log_val(self, epoch: int, errors: Dict[str, float]):
        if self.write:
            log_errors(self.val_log, epoch, errors)
        self.metrics.add(epoch, {f"val_{k}": v for k, v in errors.items()})
