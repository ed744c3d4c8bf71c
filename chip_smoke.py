#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``handnet_tpu_torch``) on one NVIDIA card.

Run from the repository root, with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device, ``nvcc`` and ``nvidia-smi``, and no network; it
imports nothing of jax or of the JAX package. Phases, each printing before
the next starts:

1. card: ``nvidia-smi`` name and power limit, torch and CUDA versions.
2. build: compiles ``handnet_tpu_torch/csrc/*.cu`` for sm_90a (first use).
3. kernels: K1 (A2J decode) and K2 (GroupNorm statistics) against their
   plain PyTorch versions at the fast profile's shapes, in float32 and
   bfloat16, with their times and the plain versions' (CUDA events).
4. slice: ``HandNetPipeline`` at the fast operating point (480x640, full
   widths, seeded random weights, score threshold 0) answers three batches
   of 8 and one of 128 in bf16 through the kernels; the launch counts must
   be K1 once and K2 24 times per call. Then the float32 kernel path is
   held against the plain path on the card and against the port's own CPU
   run.
5. throughput: frames/s at batch 128 in bf16, kernels and plain versions
   in turns.

The line before the last is one JSON object ``{"kernels": [...]}``; the last
is ``{"ok": true, "device": {...}}``. Any failure raises, and the script
exits non-zero without that line.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

# Seed of the random weights. With seed 2 the detector's random weights rank
# the hand class (2) first on most anchors, so at score threshold 0 every
# frame takes the found path (seeds 0, 4, 5, 6 rank another class first on
# nearly every anchor, and no frame would).
SEED = 2
SLICE_REQUESTS = (8, 8, 8, 128)   # batch sizes of the slice's calls
GN_LAYERS_PER_CALL = 24           # 2 towers x 4 GroupNorms x 3 FPN levels
GN_LEVELS = ((60, 80), (30, 40), (15, 20))  # FPN P3-P5 at 480x640


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms over ``iters`` launches (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def check(name: str, got, want, tol: float) -> float:
    """Max abs error of ``got`` against ``want``; raises above ``tol``."""
    import torch

    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)} "
                             f"or non-finite values")
    err = (got.double() - want.double()).abs().max().item()
    if not err <= tol:
        raise AssertionError(f"{name}: max |err| {err:.3e} > tol {tol:.3e}")
    return err


def phase_kernels(dev):
    """K1 and K2 against their plain versions on the card; returns the
    numbers of the JSON line (everything but the launch counts)."""
    import torch

    from handnet_tpu_torch.ops.anchors import a2j_anchor_grid
    from handnet_tpu_torch.ops.cuda_a2j import a2j_decode, a2j_decode_reference
    from handnet_tpu_torch.ops.cuda_gn import gn_group_stats, gn_group_stats_reference

    gen = torch.Generator(device=dev).manual_seed(SEED)
    results = {}

    # K1: B=128, N=11*11*16, P=21. Outputs are pixel positions (|x| up to
    # ~200 with these offsets); tolerance 1e-4 of that scale: float32
    # accumulations in another order, the same inputs on both sides.
    b, n, p = 128, 1936, 21
    cls = torch.randn(b, n, p, device=dev, generator=gen) * 2
    reg = torch.randn(b, n, p, 2, device=dev, generator=gen) * 5
    depth = torch.randn(b, n, p, device=dev, generator=gen)
    anchors = torch.from_numpy(a2j_anchor_grid(11, 11, 16)).to(dev)
    errs, times = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        c, r, d = (t.to(dtype) for t in (cls, reg, depth))
        want = a2j_decode_reference(c, r, d, anchors)
        tol = 1e-4 * max(1.0, want.abs().max().item())
        errs.append(check(f"K1 {dtype}", a2j_decode(c, r, d, anchors), want, tol))
        times[dtype] = (cuda_ms(lambda: a2j_decode(c, r, d, anchors)),
                        cuda_ms(lambda: a2j_decode_reference(c, r, d, anchors)))
        log("kernels", f"K1 a2j_decode B={b} N={n} P={p} {dtype}: max|err| {errs[-1]:.3e} "
            f"(tol {tol:.1e}); kernel {times[dtype][0]:.4f} ms, plain {times[dtype][1]:.4f} ms")
    # strided views: cls with N innermost, reg with every other channel pair
    c = torch.randn(b, p, n, device=dev, generator=gen).transpose(1, 2)
    r = torch.randn(b, n, p, 4, device=dev, generator=gen)[..., ::2]
    want = a2j_decode_reference(c, r, depth, anchors)
    errs.append(check("K1 strided", a2j_decode(c, r, depth, anchors), want,
                      1e-4 * max(1.0, want.abs().max().item())))
    log("kernels", f"K1 strided inputs float32: max|err| {errs[-1]:.3e}")
    ms, plain_ms = times[torch.bfloat16]
    results["a2j_decode"] = {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms}

    # K2: B=128, C=256, G=32 at the three FPN levels. Statistics of N(2, 3)
    # data; tolerance 1e-4 of their scale (float32 reductions of up to 38,400
    # values in another order).
    errs, times = [], {}
    for h, w in GN_LEVELS:
        x = torch.randn(128, h, w, 256, device=dev, generator=gen) * 3 + 2
        for dtype in (torch.float32, torch.bfloat16):
            xd = x.to(dtype)
            want = gn_group_stats_reference(xd, 32)
            tol = 1e-4 * max(1.0, want.abs().max().item())
            errs.append(check(f"K2 {h}x{w} {dtype}", gn_group_stats(xd, 32), want, tol))
            times[(h, w, dtype)] = (cuda_ms(lambda: gn_group_stats(xd, 32)),
                                    cuda_ms(lambda: gn_group_stats_reference(xd, 32)))
            kt, pt = times[(h, w, dtype)]
            log("kernels", f"K2 gn_group_stats B=128 {h}x{w}x256 G=32 {dtype}: max|err| "
                f"{errs[-1]:.3e} (tol {tol:.1e}); kernel {kt:.4f} ms, plain {pt:.4f} ms")
    # mean >> std: E[x^2]-E[x]^2 would lose the variance entirely in float32
    x = 1000.0 + 0.1 * torch.randn(8, 60, 80, 256, device=dev, generator=gen)
    got, want = gn_group_stats(x, 32), gn_group_stats_reference(x, 32)
    errs.append(check("K2 mean>>std mean", got[:, 0], want[:, 0], 2e-3))
    rel = ((got[:, 1] - want[:, 1]).abs() / want[:, 1]).max().item()
    if not rel <= 1e-2 or not bool((got[:, 1] > 0).all()):
        raise AssertionError(f"K2 mean>>std: variance rel err {rel:.3e} > 1e-2")
    log("kernels", f"K2 mean>>std (1000 + 0.1 N(0,1)) float32: mean max|err| {errs[-1]:.3e} "
        f"(tol 2e-3), variance max rel err {rel:.3e} (tol 1e-2)")
    ms, plain_ms = times[(60, 80, torch.bfloat16)]
    results["gn_group_stats"] = {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms}
    return results


def make_frames(batch: int, dev, seed: int):
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    images = torch.rand(batch, 480, 640, 3, device=dev, generator=gen)
    depth = 0.3 + 0.7 * torch.rand(batch, 480, 640, device=dev, generator=gen)
    paras = torch.tensor([[600.0, 600.0, 320.0, 240.0]], device=dev).repeat(batch, 1)
    return images, depth, paras


def check_outputs(out, batch: int, crop: int, joints: int) -> None:
    import torch

    shapes = {"joints_uvd": (batch, joints, 3), "joints_uvd_full": (batch, joints, 3),
              "joints_xyz": (batch, joints, 3), "boxes": (batch, 4),
              "crops": (batch, crop, crop, 1), "found": (batch,), "scores": (batch,),
              "sides": (batch,)}
    for key, shape in shapes.items():
        if tuple(out[key].shape) != shape:
            raise AssertionError(f"{key}: shape {tuple(out[key].shape)} != {shape}")
        if out[key].is_floating_point() and not bool(torch.isfinite(out[key]).all()):
            raise AssertionError(f"{key}: non-finite values")
    if not bool(out["found"].all()):
        raise AssertionError(f"found: {int(out['found'].sum())}/{batch} frames")


def compare_outputs(name: str, got, want, joint_tol: float) -> float:
    """Exact detection/crop outputs, joints within ``joint_tol`` (px / mm)."""
    import torch

    for key in ("found", "sides", "boxes", "crops"):
        if not torch.equal(got[key].cpu(), want[key].cpu()):
            raise AssertionError(f"{name}: {key} differ")
    err = 0.0
    for key, scale in (("joints_uvd", 1.0), ("joints_uvd_full", 1.0), ("joints_xyz", 10.0)):
        err = max(err, check(f"{name} {key}", got[key].cpu(), want[key].cpu(),
                             joint_tol * scale))
    return err


def phase_slice(dev, cfg):
    import torch

    from handnet_tpu_torch.models.pipeline import HandNetPipeline
    from handnet_tpu_torch.ops.cuda_a2j import a2j_decode
    from handnet_tpu_torch.ops.cuda_gn import gn_group_stats

    crop, joints = cfg.pipeline.crop_size, cfg.a2j.num_joints
    pipe = HandNetPipeline(cfg, dtype=torch.bfloat16, device=dev, seed=SEED)
    requests = [make_frames(bsz, dev, seed=100 + i) for i, bsz in enumerate(SLICE_REQUESTS)]
    torch.cuda.synchronize()

    gn_group_stats.launches = 0
    a2j_decode.launches = 0
    start = time.perf_counter()
    outs = [pipe(*req) for req in requests]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = {"gn_group_stats": gn_group_stats.launches, "a2j_decode": a2j_decode.launches}
    for out, bsz in zip(outs, SLICE_REQUESTS):
        check_outputs(out, bsz, crop, joints)
    calls = len(SLICE_REQUESTS)
    if launches != {"gn_group_stats": GN_LAYERS_PER_CALL * calls, "a2j_decode": calls}:
        raise AssertionError(f"launch counts {launches} for {calls} calls: expected "
                             f"K2 {GN_LAYERS_PER_CALL} and K1 1 per call")
    log("slice", f"bf16 calls of batch {list(SLICE_REQUESTS)} in {seconds:.3f} s (first "
        f"calls, cuDNN set-up included): all frames found, outputs finite; launches {launches}")
    del pipe, outs, requests

    # float32, TF32 off: the kernel path against the plain path on the card,
    # and against the port's own CPU run (which the CPU tests tie to JAX)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    images, depth, paras = make_frames(8, dev, seed=200)
    kern = HandNetPipeline(cfg, device=dev, seed=SEED)
    out_k = kern(images, depth, paras)
    del kern
    plain = HandNetPipeline(cfg, device=dev, use_kernels=False, seed=SEED)
    out_p = plain(images, depth, paras)
    del plain
    err_plain = compare_outputs("kernels vs plain (card, f32)", out_k, out_p, 1e-2)
    log("slice", f"f32 batch 8: kernel path == plain path on found/sides/boxes/crops; "
        f"joints max|err| {err_plain:.3e} (tol 1e-2 px, 1e-1 mm)")
    cpu = HandNetPipeline(cfg, device="cpu", seed=SEED)
    out_c = cpu(images[:2].cpu(), depth[:2].cpu(), paras[:2].cpu())
    del cpu
    err_cpu = compare_outputs("card vs CPU (f32)", {k: v[:2] for k, v in out_k.items()},
                              out_c, 5e-2)
    log("slice", f"f32 2 frames: card kernel path == CPU run on found/sides/boxes/crops; "
        f"joints max|err| {err_cpu:.3e} (tol 5e-2 px, 5e-1 mm)")
    torch.backends.cudnn.allow_tf32 = True
    return launches


def phase_throughput(dev, cfg) -> None:
    import torch

    from handnet_tpu_torch.models.pipeline import HandNetPipeline

    images, depth, paras = make_frames(128, dev, seed=300)
    pipes = {"kernels": HandNetPipeline(cfg, dtype=torch.bfloat16, device=dev, seed=SEED),
             "plain": HandNetPipeline(cfg, dtype=torch.bfloat16, device=dev,
                                      use_kernels=False, seed=SEED)}
    iters = 10
    fps = {"kernels": [], "plain": []}
    for name in ("kernels", "plain", "plain", "kernels"):
        pipe = pipes[name]
        for _ in range(2):
            pipe(images, depth, paras)
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(iters):
            pipe(images, depth, paras)
        torch.cuda.synchronize()
        fps[name].append(128 * iters / (time.perf_counter() - start))
    for name, vals in fps.items():
        log("throughput", f"bf16 batch 128, {name}: "
            + ", ".join(f"{v:.2f}" for v in vals) + " frames/s "
            f"(mean {sum(vals) / len(vals):.2f}; {iters} calls per run, "
            "host clock around synchronize)")
    log("throughput", f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    log("card", f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    dev = torch.device("cuda", 0)

    from handnet_tpu_torch.config import FAST, load_config
    from handnet_tpu_torch.kernels import build

    res = build.build_library()
    build.load_library()
    log("build", f"{res.path.name} in {res.seconds:.2f} s (0 = already built)")
    for line in res.log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            log("build", line.strip())

    results = phase_kernels(dev)

    cfg = load_config(overrides=FAST)
    cfg = dataclasses.replace(cfg, fcos=dataclasses.replace(cfg.fcos, score_thresh=0.0))
    launches = phase_slice(dev, cfg)
    phase_throughput(dev, cfg)

    sources = {"a2j_decode": ("handnet_tpu_torch/csrc/a2j_decode.cu",
                              "handnet_tpu/ops/pallas_a2j.py:55"),
               "gn_group_stats": ("handnet_tpu_torch/csrc/gn_stats.cu",
                                  "handnet_tpu/ops/pallas_gn.py:138")}
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": replaces,
                "launches": launches[name], **results[name]}
               for name, (src, replaces) in sources.items()]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
