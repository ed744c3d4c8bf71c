"""Bake the benchmark's static-int8 calibration file for the port.

The port's counterpart of ``tools/bake_bench_calibration.py``. The
``quant_static`` operating point serves only after every static int8 layer
has its activation amax (``HandNetPipeline.calibrate`` or
``nn.quant.load_calibration``). This tool calibrates the benchmark's
pipeline, seed-0 weights in bfloat16, on the first ``--batch`` of the
benchmark's seed-0 frames (``np.random.default_rng(0)``: 128 uniform
480x640 RGB frames, then 128 uniform depth maps in [0.3, 1.0)), and writes
the amaxes with ``nn.quant.save_calibration``, under the JAX package's
keys, so that a benchmark loads them instead of calibrating before it
times.

The file describes the port's weights: its seed-0 init is a
``torch.Generator``, not JAX's ``PRNGKey(0)``, so the tool never writes
``configs/bench_calib.npz`` (the JAX package's file, of JAX's weights).
Amaxes are statistics of the device's bf16 convolutions, so bake on the
device that serves. The card by default (``RuntimeError`` where there is
none); ``--device cpu`` runs on the CPU:

    python -m handnet_tpu_torch.tools.bake_bench_calibration [--batch 8] \\
        [--out FILE] [--device cpu]

Another operating point with static int8 (turbo's 2-conv towers have fewer
int8 layers) is baked from Python: ``bake(resolve_config("turbo",
quant="static"), out)``.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from handnet_tpu_torch.config import HandNetConfig, resolve_config
from handnet_tpu_torch.models.pipeline import HandNetPipeline
from handnet_tpu_torch.nn.quant import assert_calibrated, npz_path, save_calibration

REPO = Path(__file__).resolve().parent.parent.parent
DEFAULT_OUT = REPO / "build" / "handnet_tpu_torch" / "bench_calib.npz"
JAX_FILE = REPO / "configs" / "bench_calib.npz"   # the JAX package's, of JAX's weights
FRAME_HW = (480, 640)       # the benchmark's frames


def bench_frames(n: int, full: int, h: int = FRAME_HW[0],
                 w: int = FRAME_HW[1]) -> Tuple[np.ndarray, np.ndarray]:
    """The first ``n`` of the benchmark's frames: float32 RGB ``[n, h, w, 3]``
    in [0, 1) and depth ``[n, h, w]`` in [0.3, 1.0), equal to drawing all
    ``full`` images and then all ``full`` depth maps from
    ``np.random.default_rng(0)`` and keeping the first ``n`` of each.
    The images past ``n`` are skipped by advancing the generator (one
    64-bit draw per uniform double) instead of being drawn."""
    if not 0 < n <= full:
        raise ValueError(f"bench_frames: n={n} must be in 1..{full}")
    rng = np.random.default_rng(0)
    images = rng.uniform(size=(n, h, w, 3)).astype(np.float32)
    rng.bit_generator.advance((full - n) * h * w * 3)
    depth = rng.uniform(0.3, 1.0, size=(n, h, w)).astype(np.float32)
    return images, depth


def bake(cfg: HandNetConfig, out: str, batch: int = 8, seed: int = 0,
         device: Optional[torch.device | str] = None) -> Tuple[HandNetPipeline, int]:
    """Calibrate ``HandNetPipeline(cfg, seed=seed)`` in bfloat16 on
    ``device`` with the first ``batch`` benchmark frames (of
    ``cfg.train.batch_size``) and write its amaxes to ``out``. Returns the
    calibrated pipeline and the number of amaxes written. Refuses to
    write the JAX package's ``configs/bench_calib.npz``."""
    if Path(npz_path(str(out))).resolve() == JAX_FILE:
        raise ValueError(f"bake_bench_calibration: {JAX_FILE} is the JAX package's file")
    pipe = HandNetPipeline(cfg, dtype=torch.bfloat16, device=device, seed=seed)
    if not pipe.needs_calibration():
        raise ValueError("bake_bench_calibration: the config has no static int8 layer")
    images, depth = bench_frames(batch, cfg.train.batch_size)
    dev = next(pipe.parameters()).device
    pipe.calibrate(torch.from_numpy(images).to(dev), torch.from_numpy(depth).to(dev))
    assert_calibrated(pipe)
    Path(out).parent.mkdir(parents=True, exist_ok=True)
    return pipe, save_calibration(out, pipe)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=8,
                        help="frames of the benchmark's seed-0 draw to calibrate on")
    parser.add_argument("--out", default=str(DEFAULT_OUT),
                        help="calibration npz to write (default: under build/)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card; 'cpu' runs on the CPU)")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    _, count = bake(resolve_config("quant_static"), args.out, args.batch, device=args.device)
    print(f"saved {count} calibration scalars -> {npz_path(args.out)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
