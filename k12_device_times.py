#!/usr/bin/env python3
"""Time K1 (A2J decode) and K2 (GroupNorm) of a checkout of the port twice:
by a loop of wrapper calls between two CUDA events (``chip_smoke.cuda_ms``,
which the host bounds when the kernel is short) and by the kernels' own
durations (``chip_smoke.device_ms``, torch.profiler).

Run from the repository root on a CUDA card::

    python3 k12_device_times.py                     # this checkout's port
    python3 k12_device_times.py --root build/parent # a port unpacked elsewhere

``--sweep`` (this checkout only) adds the B=128 bf16 times for other values of
the wrappers' blocks-per-SM targets, which set how many splits an image gets.

``--k1-hash`` prints only the SHA-256 of K1's output at B=128, N=1936, P=21,
bf16 on seeded heads (``chip_smoke.k1_output_hash``; ``chip_smoke.py``'s
``[a2j_2d]`` phase prints it too): run it with and without ``--root`` in one
call to check that two checkouts' K1 give the same bits.

``--gn-backward`` times only GroupNorm + ReLU's train route at
``chip_smoke.GN_TRAIN_SHAPE`` ([8, 100, 136, 256], G=32) in bf16 with
float32 parameters: forward + backward, the backward alone, and K2r and
K2d alone; then K2r and K2d alone (ReLU on, float32 parameters) at the
GroupNorm backbone's five shapes (B=8 bf16, ``chip_smoke.BACKBONE_GN_SHAPES``)
and at A2J-GN's eleven (B=64 bf16, ``chip_smoke.A2J_GROUP_TRAIN_SHAPES``; the
three 11x11 ones in float32 too), each beside its byte bound and
``aten.native_group_norm_backward`` for the same outputs. A port without K2r
(``gn_backward_sums``) is timed with the gradients registered on its
forward ops, and one whose K2r refuses a width says so, so one call with
and without ``--root`` gives the times before and after. With ``--sweep``
(this checkout only) K2r is timed at A2J-GN's 11x11 shapes, the backbone's
25x34x512 and P3 over ``cuda_gn.SUMS_BLOCKS_PER_SM`` and
``cuda_gn.SUMS_IMAGE_FOLD``.

``--gn-backward-hash`` prints only the SHA-256 of K2r's sums and dparams,
of K2d's dx on K2r's sums and of K2d's dx on the plain sums (ReLU on,
float32 parameters) at P3 and the backbone's five shapes (B=8, G=32),
float32 and bf16, and one hash over all of them: run it with and without
``--root`` in one call to check whether two checkouts' K2r and K2d give
the same bits.

``--gn-hash`` prints only the SHA-256 of K2s's statistics and of K2a's
output (ReLU, float32 parameters) on seeded inputs at the fast profile's P3
(B=128, 60x80x256) and at the GroupNorm backbone's five shapes (B=8,
``chip_smoke.BACKBONE_GN_SHAPES``), float32 and bf16, G=32, with both
kernels' device times there: run it with and without ``--root`` in one
call to check that two checkouts' K2s and K2a give the same bits at the
widths both take.

``--root`` names a directory that holds another ``handnet_tpu_torch`` (for
example the parent commit, unpacked with ``git archive``); its kernels build
into that directory's ``build/``. A port that has no K2a (``gn_apply``) is
timed with the plain apply it runs instead. Every line names the card.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

LEVELS = ((60, 80), (30, 40), (15, 20))   # FPN P3-P5 at 480x640
HBM_BYTES_PER_S = 3.35e12


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=None, help="directory holding handnet_tpu_torch")
    parser.add_argument("--sweep", action="store_true",
                        help="also time other blocks-per-SM targets at B=128")
    parser.add_argument("--k1-hash", action="store_true",
                        help="print only the hash of K1's output on seeded inputs")
    parser.add_argument("--gn-hash", action="store_true",
                        help="print only the hashes and device times of K2s and K2a at the "
                             "old shapes on seeded inputs")
    parser.add_argument("--gn-backward", action="store_true",
                        help="time only GroupNorm + ReLU's train route at P3, and K2r and K2d at "
                             "the backbone's and A2J-GN's shapes")
    parser.add_argument("--gn-backward-hash", action="store_true",
                        help="print only the hashes of K2r's and K2d's outputs at P3 and the "
                             "backbone's shapes on seeded inputs")
    args = parser.parse_args()
    here = Path(__file__).resolve().parent
    sys.path.insert(0, str(here))
    from chip_smoke import GN_TRAIN_SHAPE, cuda_ms, device_ms, k1_output_hash
    if args.root:
        sys.path.insert(0, str(Path(args.root).resolve()))

    import torch
    if not torch.cuda.is_available():
        print("k12_device_times: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    import handnet_tpu_torch
    from handnet_tpu_torch.kernels import build
    from handnet_tpu_torch.ops import cuda_a2j, cuda_gn
    from handnet_tpu_torch.ops.anchors import a2j_anchor_grid

    res = build.build_library()
    build.load_library()
    print(f"[{card}] port at {Path(handnet_tpu_torch.__file__).parent}, built in "
          f"{res.seconds:.2f} s", flush=True)
    for line in res.log.splitlines():
        if ("registers" in line or "Compiling entry" in line) and (
                "gn_" in line or "a2j" in line or "registers" in line):
            print("  " + line.strip())
    dev = torch.device("cuda", 0)
    if args.k1_hash:
        print(f"[{card}] K1 output hash (B=128 N=1936 P=21 bf16, seed 2): "
              f"{k1_output_hash(dev)}", flush=True)
        return 0
    gen = torch.Generator(device=dev).manual_seed(2)

    def report(name, n_bytes, fn, cold=None):
        loop, device = cuda_ms(fn), device_ms(fn)
        line = (f"[{card}] {name}: wrapper loop {loop:.4f} ms, device {device:.4f} ms, bound "
                f"{n_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms ({n_bytes} bytes / 3.35 TB/s)")
        if cold:
            line += f", device over {len(cold)} input sets in turn {device_ms(cold):.4f} ms"
        print(line, flush=True)

    if args.gn_backward:
        gn_backward(GN_TRAIN_SHAPE, dev, gen, cuda_gn, report)
        if hasattr(cuda_gn, "gn_backward_sums"):
            gn_backward_shapes(card, dev, cuda_gn)
            if args.sweep and not args.root:
                gn_backward_sweep(card, dev, cuda_gn)
        return 0
    if args.gn_backward_hash:
        gn_backward_hashes(card, dev, cuda_gn)
        return 0
    if args.gn_hash:
        gn_hashes(card, dev, cuda_gn, device_ms)
        return 0

    n, p = 1936, 21
    anchors = torch.from_numpy(a2j_anchor_grid(11, 11, 16)).to(dev)
    for b in (1, 8, 128):
        sets = []
        for _ in range(4):
            sets.append((
                (torch.randn(b, n, p, device=dev, generator=gen) * 2).bfloat16(),
                (torch.randn(b, n, p, 2, device=dev, generator=gen) * 5).bfloat16(),
                torch.randn(b, n, p, device=dev, generator=gen).bfloat16()))
        calls = [lambda s=s: cuda_a2j.a2j_decode(*s, anchors) for s in sets]
        report(f"K1 a2j_decode B={b} N={n} P={p} bf16",
               4 * b * n * p * 2 + n * 2 * 4 + b * p * 3 * 4, calls[0], cold=calls)

    apply_kernel = getattr(cuda_gn, "gn_apply", None)
    scale = torch.rand(256, device=dev, generator=gen).bfloat16() + 0.5
    bias = torch.randn(256, device=dev, generator=gen).bfloat16()
    for b in (1, 8, 128):
        for h, w in LEVELS:
            sets = [(torch.randn(b, h, w, 256, device=dev, generator=gen) * 3 + 2).bfloat16()
                    for _ in range(4 if b * h * w * 512 < 60e6 else 1)]
            x = sets[0]
            n_bytes = x.numel() * 2
            report(f"K2 statistics B={b} {h}x{w}x256 G=32 bf16", n_bytes + b * 2 * 32 * 4,
                   lambda: cuda_gn.gn_group_stats(x, 32),
                   cold=[lambda x=x: cuda_gn.gn_group_stats(x, 32) for x in sets]
                   if len(sets) > 1 else None)
            if apply_kernel is not None:
                stats = cuda_gn.gn_group_stats(x, 32)
                report(f"K2a apply+ReLU B={b} {h}x{w}x256 bf16", 2 * n_bytes,
                       lambda: apply_kernel(x, stats, scale, bias, 1e-5, True))
                report(f"group_norm+ReLU (K2s, K2a) B={b} {h}x{w}x256 bf16", 2 * n_bytes,
                       lambda: cuda_gn.group_norm(x, scale, bias, 32, relu=True))
            else:
                report(f"group_norm, then relu_ (K2, plain apply) B={b} {h}x{w}x256 bf16",
                       2 * n_bytes,
                       lambda: torch.relu_(cuda_gn.group_norm(x, scale, bias, 32)))
    if args.sweep:
        sweep(card, dev, gen, cuda_a2j, cuda_gn, anchors, device_ms)
    return 0


def gn_backward(shape, dev, gen, cuda_gn, report) -> None:
    """GroupNorm + ReLU with grad at ``shape`` (B, H, W, C), G=32, bf16
    activations and float32 parameters, as the trainer runs it: forward +
    backward, the backward alone (one graph, kept), and, where the port has
    them, K2r and K2d alone."""
    import torch

    b, h, w, c = shape
    x = (torch.randn(b, h, w, c, device=dev, generator=gen) * 3 + 2).bfloat16()
    dy = torch.randn(b, h, w, c, device=dev, generator=gen).bfloat16()
    scale = (torch.rand(c, device=dev, generator=gen) + 0.5).requires_grad_()
    bias = torch.randn(c, device=dev, generator=gen).requires_grad_()
    xk = x.clone().requires_grad_()
    inputs = (xk, scale, bias)
    tensor = x.numel() * 2
    kernels = hasattr(cuda_gn, "gn_backward_sums")
    route = ("K2s+K2a, K2r+K2d" if kernels
             else "K2s+K2a, the registered plain gradient")
    name = f"B={b} {h}x{w}x{c} G=32 bf16, f32 params, ReLU"

    def forward():
        return cuda_gn.group_norm(xk, scale, bias, 32, relu=True)

    report(f"GroupNorm+ReLU forward + backward ({route}) {name}", 4 * tensor,
           lambda: torch.autograd.grad(forward(), inputs, dy))
    y = forward()
    report(f"GroupNorm+ReLU backward alone ({route.split(', ')[1]}) {name}; bound: x, dy read, "
           "dx written", 3 * tensor,
           lambda: torch.autograd.grad(y, inputs, dy, retain_graph=True))
    if kernels:
        stats = cuda_gn.gn_group_stats(x, 32)
        sc, bi = scale.detach(), bias.detach()
        sums, _ = cuda_gn.gn_backward_sums(x, dy, stats, sc, bi, 1e-5, True)
        report(f"K2r gn_backward_sums {name}", 2 * tensor,
               lambda: cuda_gn.gn_backward_sums(x, dy, stats, sc, bi, 1e-5, True))
        report(f"K2d gn_backward_dx {name}", 3 * tensor,
               lambda: cuda_gn.gn_backward_dx(x, dy, stats, sc, bi, sums, 1e-5, True))


def k2r_k2d_inputs(dev, b: int, h: int, w: int, c: int, dtype, seed: int):
    """Seeded x (3 N(0, 1) + 2), dy, float32 scale and bias at one shape."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(b, h, w, c, device=dev, generator=gen) * 3 + 2).to(dtype)
    dy = torch.randn(b, h, w, c, device=dev, generator=gen).to(dtype)
    scale = torch.rand(c, device=dev, generator=gen) + 0.5
    bias = torch.randn(c, device=dev, generator=gen)
    return x, dy, scale, bias


def gn_backward_shapes(card, dev, cuda_gn) -> None:
    """K2r and K2d alone (ReLU on, float32 parameters, G=32) at the
    backbone's five shapes (B=8 bf16) and A2J-GN's (B=64 bf16; the 11x11
    ones in float32 too), on the device, beside their byte bounds (K2r: x
    and dy read; K2d: x and dy read, dx written) and
    ``aten.native_group_norm_backward`` for dscale and dbias and for dx
    (NCHW copies, its own sums, no ReLU). Each line names the port's
    ``sums_plan`` where it has one."""
    import torch
    from chip_smoke import (A2J_GROUP_TRAIN_BATCH, A2J_GROUP_TRAIN_SHAPES, BACKBONE_GN_SHAPES,
                            TRAIN_BATCH, device_ms, native_group_norm_backward)

    eps = 1e-5
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cases = [(TRAIN_BATCH, shape, torch.bfloat16, layers)
             for shape, layers in BACKBONE_GN_SHAPES.items()]
    cases += [(A2J_GROUP_TRAIN_BATCH, shape, dtype, layers)
              for shape, layers in A2J_GROUP_TRAIN_SHAPES.items()
              for dtype in ((torch.bfloat16, torch.float32) if shape[:2] == (11, 11)
                            else (torch.bfloat16,))]
    for b, (h, w, c, g), dtype, layers in cases:
        kind = "f32" if dtype == torch.float32 else "bf16"
        name = f"B={b} {h}x{w}x{c} G={g} {kind}, f32 params, ReLU ({layers} layers)"
        x, dy, scale, bias = k2r_k2d_inputs(dev, b, h, w, c, dtype, 2)
        stats = cuda_gn.gn_group_stats(x, g)
        tensor = x.numel() * x.element_size()
        try:
            sums, _ = cuda_gn.gn_backward_sums(x, dy, stats, scale, bias, eps, True)
        except ValueError as err:
            print(f"[{card}] K2r/K2d {name}: refused ({err})", flush=True)
            continue
        r_ms = device_ms(lambda: cuda_gn.gn_backward_sums(x, dy, stats, scale, bias, eps, True))
        d_ms = device_ms(lambda: cuda_gn.gn_backward_dx(x, dy, stats, scale, bias, sums, eps,
                                                        True))
        lib_r = device_ms(native_group_norm_backward(x, dy, scale, bias, g,
                                                     [False, True, True], eps))
        lib_d = device_ms(native_group_norm_backward(x, dy, scale, bias, g,
                                                     [True, False, False], eps))
        r_bound = 2 * tensor / HBM_BYTES_PER_S * 1e3
        d_bound = 3 * tensor / HBM_BYTES_PER_S * 1e3
        plan = (f", plan {tuple(cuda_gn.sums_plan(b, h * w, c, x.element_size(), sms))}"
                if hasattr(cuda_gn, "sums_plan") else "")
        print(f"[{card}] K2r/K2d {name}: K2r {r_ms:.4f} ms on the device (bound {r_bound:.4f}, "
              f"{r_bound / r_ms:.0%}), K2d {d_ms:.4f} (bound {d_bound:.4f}, "
              f"{d_bound / d_ms:.0%}); native_group_norm_backward dscale+dbias {lib_r:.4f}, dx "
              f"{lib_d:.4f}{plan}", flush=True)
        del x, dy, stats, sums


def gn_backward_sweep(card, dev, cuda_gn) -> None:
    """K2r's device time (bf16, ReLU, float32 parameters) over its plan's
    ``SUMS_BLOCKS_PER_SM`` and ``SUMS_IMAGE_FOLD`` at A2J-GN's 11x11 shapes
    (B=64), the backbone's 25x34x512 (B=8) and P3."""
    from chip_smoke import A2J_GROUP_TRAIN_BATCH, GN_TRAIN_SHAPE, TRAIN_BATCH, device_ms
    import torch

    kept = cuda_gn.SUMS_BLOCKS_PER_SM, cuda_gn.SUMS_IMAGE_FOLD
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    shapes = [(A2J_GROUP_TRAIN_BATCH, 11, 11, c) for c in (256, 1024, 2048)]
    shapes += [(TRAIN_BATCH, 25, 34, 512), GN_TRAIN_SHAPE]
    try:
        for b, h, w, c in shapes:
            x, dy, scale, bias = k2r_k2d_inputs(dev, b, h, w, c, torch.bfloat16, 2)
            stats = cuda_gn.gn_group_stats(x, 32)
            for per_sm in (1, 2, 3, 4):
                for fold in ((4, 8, 16) if b > 8 else (8,)):
                    cuda_gn.SUMS_BLOCKS_PER_SM, cuda_gn.SUMS_IMAGE_FOLD = per_sm, fold
                    plan = cuda_gn.sums_plan(b, h * w, c, 2, sms)
                    ms = device_ms(lambda: cuda_gn.gn_backward_sums(x, dy, stats, scale, bias,
                                                                    1e-5, True), iters=40)
                    print(f"[{card}] sweep K2r B={b} {h}x{w}x{c} bf16 SUMS_BLOCKS_PER_SM="
                          f"{per_sm} SUMS_IMAGE_FOLD={fold} {tuple(plan)}: device {ms:.4f} ms",
                          flush=True)
            del x, dy, stats
    finally:
        cuda_gn.SUMS_BLOCKS_PER_SM, cuda_gn.SUMS_IMAGE_FOLD = kept


def gn_backward_hashes(card, dev, cuda_gn) -> None:
    """SHA-256 of K2r's (sums, dparams), of K2d's dx on them and of K2d's
    dx on the plain sums (ReLU on, float32 parameters, eps 1e-5) at P3 and
    the backbone's shapes, float32 and bf16, G=32, on inputs from a
    generator seeded per shape; then one hash over all of them."""
    import hashlib

    import torch
    from chip_smoke import BACKBONE_GN_SHAPES, GN_TRAIN_SHAPE, SEED, TRAIN_BATCH, output_hash

    shapes = [GN_TRAIN_SHAPE] + [(TRAIN_BATCH, h, w, c) for h, w, c, _ in BACKBONE_GN_SHAPES]
    every = hashlib.sha256()
    for b, h, w, c in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            x, dy, scale, bias = k2r_k2d_inputs(dev, b, h, w, c, dtype, SEED)
            stats = cuda_gn.gn_group_stats(x, 32)
            sums, dparams = cuda_gn.gn_backward_sums(x, dy, stats, scale, bias, 1e-5, True)
            plain, _ = cuda_gn.gn_backward_sums_reference(x, dy, stats, scale, bias, 1e-5, True)
            digests = (output_hash(sums, dparams),
                       output_hash(cuda_gn.gn_backward_dx(x, dy, stats, scale, bias, sums, 1e-5,
                                                          True)),
                       output_hash(cuda_gn.gn_backward_dx(x, dy, stats, scale, bias, plain,
                                                          1e-5, True)))
            every.update("".join(digests).encode())
            print(f"[{card}] K2r/K2d B={b} {h}x{w}x{c} G=32 {dtype}: K2r {digests[0][:16]}, K2d "
                  f"on K2r's sums {digests[1][:16]}, K2d on the plain sums {digests[2][:16]}",
                  flush=True)
            del x, dy, stats, sums, dparams, plain
    print(f"[{card}] K2r/K2d output hash over the {len(shapes)} shapes x 2 types: "
          f"{every.hexdigest()}", flush=True)


def gn_hashes(card, dev, cuda_gn, device_ms) -> None:
    """SHA-256 of K2s's statistics and K2a's output (ReLU, float32
    parameters, eps 1e-5) at fast P3 and the GroupNorm backbone's shapes,
    float32 and bf16, G=32, on inputs from a generator seeded per shape, and
    both kernels' device times; then one hash over all of them."""
    import hashlib

    import torch
    from chip_smoke import BACKBONE_GN_SHAPES, SEED, output_hash

    shapes = [(128, 60, 80, 256)] + [(8, h, w, c) for h, w, c, _ in BACKBONE_GN_SHAPES]
    every = hashlib.sha256()
    for b, h, w, c in shapes:
        gen = torch.Generator(device=dev).manual_seed(SEED)
        x = torch.randn(b, h, w, c, device=dev, generator=gen) * 3 + 2
        scale = torch.rand(c, device=dev, generator=gen) + 0.5
        bias = torch.randn(c, device=dev, generator=gen)
        for dtype in (torch.float32, torch.bfloat16):
            xd = x.to(dtype)
            stats = cuda_gn.gn_group_stats(xd, 32)
            y = cuda_gn.gn_apply(xd, stats, scale, bias, 1e-5, True)
            digests = output_hash(stats), output_hash(y)
            every.update("".join(digests).encode())
            s_ms = device_ms(lambda: cuda_gn.gn_group_stats(xd, 32))
            a_ms = device_ms(lambda: cuda_gn.gn_apply(xd, stats, scale, bias, 1e-5, True))
            print(f"[{card}] K2s/K2a B={b} {h}x{w}x{c} G=32 {dtype}: K2s {digests[0][:16]}, "
                  f"K2a {digests[1][:16]}; device K2s {s_ms:.4f} ms, K2a+ReLU {a_ms:.4f} ms",
                  flush=True)
            del xd, stats, y
        del x
    print(f"[{card}] K2s/K2a output hash over the {len(shapes)} shapes x 2 types: "
          f"{every.hexdigest()}", flush=True)


def sweep(card, dev, gen, cuda_a2j, cuda_gn, anchors, device_ms) -> None:
    """Device times at B=128 bf16 over the plans' blocks-per-SM targets."""
    import torch

    n, p = 1936, 21
    sets = [((torch.randn(128, n, p, device=dev, generator=gen) * 2).bfloat16(),
             (torch.randn(128, n, p, 2, device=dev, generator=gen) * 5).bfloat16(),
             torch.randn(128, n, p, device=dev, generator=gen).bfloat16()) for _ in range(4)]
    kept = cuda_a2j.BLOCKS_PER_SM
    for target in (4, 6, 8, 12, 16, 24, 32):
        cuda_a2j.BLOCKS_PER_SM = target
        plan = cuda_a2j.decode_plan(128, n, p, 2,
                                    torch.cuda.get_device_properties(dev).multi_processor_count)
        ms = device_ms([lambda s=s: cuda_a2j.a2j_decode(*s, anchors) for s in sets], iters=40)
        print(f"[{card}] sweep K1 B=128 bf16 BLOCKS_PER_SM={target} {plan}: device {ms:.4f} ms "
              "(4 input sets in turn)", flush=True)
    cuda_a2j.BLOCKS_PER_SM = kept
    scale = torch.rand(256, device=dev, generator=gen).bfloat16() + 0.5
    bias = torch.randn(256, device=dev, generator=gen).bfloat16()
    kept = cuda_gn.STATS_BLOCKS_PER_SM, cuda_gn.APPLY_BLOCKS_PER_SM
    for h, w in LEVELS:
        xs = [(torch.randn(128, h, w, 256, device=dev, generator=gen) * 3 + 2).bfloat16()
              for _ in range(4 if h * w < 4800 else 1)]
        stats = cuda_gn.gn_group_stats(xs[0], 32)
        for target in (2, 4, 8, 16, 32, 64):
            cuda_gn.STATS_BLOCKS_PER_SM = cuda_gn.APPLY_BLOCKS_PER_SM = target
            s_ms = device_ms([lambda x=x: cuda_gn.gn_group_stats(x, 32) for x in xs], iters=40)
            a_ms = device_ms([lambda x=x: cuda_gn.gn_apply(x, stats, scale, bias, 1e-5, True)
                              for x in xs], iters=40)
            print(f"[{card}] sweep K2 B=128 {h}x{w}x256 bf16 blocks per SM {target}: K2s "
                  f"{s_ms:.4f} ms, K2a {a_ms:.4f} ms on the device ({len(xs)} input sets in "
                  "turn)", flush=True)
    cuda_gn.STATS_BLOCKS_PER_SM, cuda_gn.APPLY_BLOCKS_PER_SM = kept


if __name__ == "__main__":
    sys.exit(main())
