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
K2d alone. A port without K2r (``gn_backward_sums``) is timed with the
gradients registered on its forward ops, so one call with and without
``--root`` gives the times before and after.

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
                        help="time only GroupNorm + ReLU forward + backward at the P3 train shape")
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
