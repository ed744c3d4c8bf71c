#!/usr/bin/env python3
"""Where K3g's time goes: the kernel timed with parts of it compiled out.

A measuring script beside ``chip_smoke.py``, not part of the port's package:
nothing imports it.

Run on a card from the repository root::

    python3 k3g_breakdown.py

It copies ``csrc/`` into ``build/k3g_breakdown/``, edits ``int8_conv.cu`` there
(never the package's source) and builds each variant with
``kernels/build.py``:

* ``whole``: the kernel as it is;
* ``no global stores``: the epilogue dequantizes and stages, but writes nothing out;
* ``no epilogue``: TMA loads and ``wgmma`` only;
* ``loads only``: the TMA ring alone, the consumers just release the stages.

The differences price the output's stores, the epilogue's arithmetic and the
tensor-core work, each as far as it is not hidden behind the others. The
variants compute nothing useful; only ``whole`` is checked against the plain
version elsewhere (``chip_smoke.py``). The edits are anchored on lines of the
source and fail loudly when those lines change.
"""

from __future__ import annotations

import shutil
import subprocess

import torch

from handnet_tpu_torch.kernels import build
from handnet_tpu_torch.ops.cuda_int8_conv import int8_conv_gemm

_STORE = "*reinterpret_cast<uint4*>(dst) = v;"
_EPILOGUE = "epilogue<T, BN>(acc, m0 + warp * 16, n0,"
_MMA = "WgmmaS8<BN>::mma(acc, desc_a + 2 * ks, desc_b + 2 * ks, 1);"
# a condition no accumulator meets, which the compiler cannot rule out
_NEVER = "if (acc[0] == 0x7fffffff && acc[BN / 2 - 1] == 0x7ffffff1) "
VARIANTS = {
    "whole": [],
    "no global stores": [(_STORE, "if (v.x == 0x12345679u && v.y == 0x9abcdef1u) " + _STORE)],
    "no epilogue": [(_EPILOGUE, _NEVER + _EPILOGUE)],
    "loads only": [(_EPILOGUE, _NEVER + _EPILOGUE), (_MMA, "")],
}
# (h, w, cin, cout, kernel, padding) at B=128, bf16 output
SHAPES = {
    "P3 tower 3x3 60x80x256->256": (60, 80, 256, 256, 3, 1),
    "1x1 60x80x256->256": (60, 80, 256, 256, 1, 0),
    "layer1 3x3 120x160x64->64": (120, 160, 64, 64, 3, 1),
    "P4 tower 3x3 30x40x256->256": (30, 40, 256, 256, 3, 1),
    "layer4 3x3 15x20x512->512": (15, 20, 512, 512, 3, 1),
}


def _ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    gen = torch.Generator(device=dev).manual_seed(1)
    cases = {}
    for name, (h, w, cin, cout, k, p) in SHAPES.items():
        q = torch.randint(-127, 128, (128, h, w, cin), device=dev, generator=gen,
                          dtype=torch.int8)
        wq = torch.randint(-127, 128, (cout, k, k, cin), device=dev, generator=gen,
                           dtype=torch.int8)
        cases[name] = (q, wq, torch.tensor(0.01, device=dev),
                       torch.rand(cout, device=dev, generator=gen) * 1e-3,
                       torch.randn(cout, device=dev, generator=gen),
                       (1, 1), (p, p), (1, 1), torch.bfloat16)
    source_dir = build.CSRC_DIR
    variant_dir = build.BUILD_ROOT.parent / "k3g_breakdown" / "csrc"
    try:
        for variant, edits in VARIANTS.items():
            shutil.rmtree(variant_dir, ignore_errors=True)
            shutil.copytree(source_dir, variant_dir)
            text = (variant_dir / "int8_conv.cu").read_text()
            for old, new in edits:
                if text.count(old) != 1:
                    raise RuntimeError(f"k3g_breakdown: anchor {old!r} not found once in "
                                       "int8_conv.cu")
                text = text.replace(old, new)
            (variant_dir / "int8_conv.cu").write_text(text)
            build.CSRC_DIR = variant_dir
            build.load_library.cache_clear()
            times = [f"{name} {_ms(lambda: int8_conv_gemm(*args)):.4f} ms"
                     for name, args in cases.items()]
            print(f"K3g {variant}, B=128 bf16: " + "; ".join(times), flush=True)
    finally:
        build.CSRC_DIR = source_dir
        build.load_library.cache_clear()


if __name__ == "__main__":
    main()
