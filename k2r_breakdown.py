#!/usr/bin/env python3
"""Where K2r's time goes: the kernel timed with parts of it compiled out.

A measuring script beside ``chip_smoke.py``, not part of the port's package:
nothing imports it.

Run on a card from the repository root::

    python3 k2r_breakdown.py

It copies ``csrc/`` into ``build/k2r_breakdown/``, edits
``gn_backward_sums.cu`` there (never the package's source) and builds each
variant with ``kernels/build.py``:

* ``whole``: the kernel as it is (also timed without the ReLU mask);
* ``no walk``: every block skips its pixels (no loads of x and dy) and
  folds zeros, so the coefficients' loads and the three folds remain;
* ``walk only``: each block's walk, its rows' tree and its partial, and
  no fold at all;
* ``+ image counter``: and the image's counter, its last block stopping
  there;
* ``+ splits' fold``: and that block's fold of the image's splits;
* ``+ group sums``: and the image's S1 and S2 (the scales staged, the
  group loop);
* ``image folds only``: and the image's terms, but not the two folds over
  the images.

The differences price the walk, each step of the image's last block and
the folds over the images, each as far as it is not hidden behind the
others.
The variants compute nothing useful; only ``whole`` is checked against the
plain version elsewhere (``chip_smoke.py``). The edits are anchored on lines
of the source and fail loudly when those lines change. Device times come
from ``chip_smoke.device_ms`` (torch.profiler), at A2J-GN's 11x11 shapes at
B=64 and the GroupNorm backbone's 25x34x512 and P3 at B=8, bf16 and
float32, float32 parameters.
"""

from __future__ import annotations

import shutil
import subprocess

import torch

from chip_smoke import device_ms
from handnet_tpu_torch.kernels import build
from handnet_tpu_torch.ops.cuda_gn import gn_backward_sums, gn_group_stats

_WALK = "  int p = p0 + row;\n"
_IMAGE_DONE = "  if (!last_block_done(counters + b, (unsigned)splits)) return;\n"
_FOLD = "  // 1. the image's last block: its splits in split order, then the image's\n"
_SPLITS_FOLDED = "  fold_columns(image_work, values, splits, values, into_planes);\n"
_TERMS = "  float* terms = image_work + (int64_t)splits * values;\n"
_RUN_DONE = "  if (!last_block_done(counters + batch + run, (unsigned)members)) return;\n"
# a read of the fold's shared memory that the compiler cannot drop
_KEEP = "  if (smem[4 * tid] == 0x1.234p-99f) dparams[0] = smem[1];\n"
VARIANTS = {
    "whole": [],
    "no walk": [(_WALK, "  int p = p1;\n")],
    "walk only": [(_IMAGE_DONE, "  return;\n")],
    "+ image counter": [(_FOLD, "  return;\n" + _FOLD)],
    "+ splits' fold": [(_SPLITS_FOLDED, _SPLITS_FOLDED + _KEEP + "  return;\n")],
    "+ group sums": [(_TERMS, "  return;\n" + _TERMS)],
    "image folds only": [(_RUN_DONE, "  return;\n")],
}
# (B, H, W, C), G=32
SHAPES = [(64, 11, 11, 256), (64, 11, 11, 1024), (64, 11, 11, 2048), (8, 25, 34, 512),
          (8, 100, 136, 256)]


def main() -> None:
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    gen = torch.Generator(device=dev).manual_seed(2)
    cases = {}
    for b, h, w, c in SHAPES:
        x = torch.randn(b, h, w, c, device=dev, generator=gen) * 3 + 2
        dy = torch.randn(b, h, w, c, device=dev, generator=gen)
        scale = torch.rand(c, device=dev, generator=gen) + 0.5
        bias = torch.randn(c, device=dev, generator=gen)
        for dtype in (torch.bfloat16, torch.float32):
            xd = x.to(dtype)
            kind = "bf16" if dtype == torch.bfloat16 else "f32"
            cases[f"B={b} {h}x{w}x{c} {kind}"] = (xd, dy.to(dtype), gn_group_stats(xd, 32),
                                                   scale, bias)
    source_dir = build.CSRC_DIR
    variant_dir = build.BUILD_ROOT.parent / "k2r_breakdown" / "csrc"
    try:
        for variant, edits in VARIANTS.items():
            shutil.rmtree(variant_dir, ignore_errors=True)
            shutil.copytree(source_dir, variant_dir)
            text = (variant_dir / "gn_backward_sums.cu").read_text()
            for old, new in edits:
                if text.count(old) != 1:
                    raise RuntimeError(f"k2r_breakdown: anchor {old!r} not found once in "
                                       "gn_backward_sums.cu")
                text = text.replace(old, new)
            (variant_dir / "gn_backward_sums.cu").write_text(text)
            build.CSRC_DIR = variant_dir
            build.load_library.cache_clear()
            for relu in (True, False) if variant == "whole" else (True,):
                times = [f"{name} {device_ms(lambda a=args: gn_backward_sums(*a, 1e-5, relu)):.4f}"
                         for name, args in cases.items()]
                print(f"K2r {variant}{'' if relu else ', no ReLU mask'}, device ms: "
                      + "; ".join(times), flush=True)
    finally:
        build.CSRC_DIR = source_dir
        build.load_library.cache_clear()


if __name__ == "__main__":
    main()
