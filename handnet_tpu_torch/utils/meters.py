"""Metric meters.

Reference equivalents: AverageMeters (utils/evaluation/evalutils.py:1-28) and
SmoothedValue/MetricLogger (fpn_utils/utils.py:11-67,113-180).

The port's copy of ``handnet_tpu/utils/meters.py``: plain host-side
accumulators. Under data parallelism :meth:`AverageMeters.reduce` sums each
meter's total and count over the ranks (the reference's
``synchronize_between_processes``, fpn_utils/utils.py:29-41), so every rank
averages over the whole world.
"""

from __future__ import annotations

from collections import defaultdict, deque
from typing import Deque, Dict

import numpy as np


class AverageMeter:
    """Running average (evalutils.py:6-28)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class AverageMeters:
    """Named meter collection (evalutils.py add_loss_value pattern)."""

    def __init__(self):
        self.meters: Dict[str, AverageMeter] = defaultdict(AverageMeter)

    def update(self, values: Dict[str, float], n: int = 1):
        for k, v in values.items():
            self.meters[k].update(v, n)

    def averages(self) -> Dict[str, float]:
        return {k: m.avg for k, m in self.meters.items()}

    def reduce(self, mesh) -> None:
        """Sum every meter's total and count over the ranks of ``mesh`` (a
        ``parallel.DataMesh``; nothing to do without one or for one rank),
        in one collective. Every rank must hold the same meter names."""
        if mesh is None or mesh.world_size == 1:
            return
        import torch

        from handnet_tpu_torch.parallel.mesh import all_reduce_sum

        names = sorted(self.meters)
        local = torch.tensor([[self.meters[k].sum, self.meters[k].count] for k in names],
                             dtype=torch.float64, device=mesh.device)
        total = all_reduce_sum(local, mesh).cpu().tolist()
        for k, (sum_, count) in zip(names, total):
            meter = self.meters[k]
            meter.sum, meter.count = sum_, int(count)
            meter.avg = meter.sum / max(meter.count, 1)

    def __getitem__(self, key: str) -> AverageMeter:
        return self.meters[key]


class SmoothedValue:
    """Windowed median/average + global stats (fpn_utils/utils.py:11-67)."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque: Deque[float] = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        value = float(value)
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self) -> float:
        # torch.median semantics (fpn_utils/utils.py:43-45): the LOWER of
        # the two middle values on even-length windows, not their mean
        if not self.deque:
            return 0.0
        vals = sorted(self.deque)
        return float(vals[(len(vals) - 1) // 2])

    @property
    def avg(self) -> float:
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def max(self) -> float:
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg, max=self.max,
                               value=self.value)


class MetricLogger:
    """Named SmoothedValues + iteration logging (fpn_utils/utils.py:113-180)."""

    def __init__(self, delimiter: str = "  ", window_size: int = 20):
        self.meters: Dict[str, SmoothedValue] = defaultdict(
            lambda: SmoothedValue(window_size))
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(v)

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self):
        return self.delimiter.join(
            f"{name}: {meter}" for name, meter in self.meters.items())

    def log_every(self, iterable, print_freq: int, header: str = "",
                  printer=print):
        import time

        i = 0
        start = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        for obj in iterable:
            t0 = time.time()
            yield obj
            iter_time.update(time.time() - t0)
            if i % print_freq == 0:
                eta = iter_time.global_avg * (len(iterable) - i)
                printer(f"{header} [{i}/{len(iterable)}] eta: {eta:.0f}s "
                        f"{self} time: {iter_time}")
            i += 1
        total = time.time() - start
        printer(f"{header} Total time: {total:.1f}s "
                f"({total / max(i, 1):.4f} s/it)")
