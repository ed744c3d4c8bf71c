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
   bfloat16, with their times and the plain versions' (CUDA events). K3
   (int8 conv) bit for bit against its plain version on every distinct
   conv geometry of the quant_static path at 480x640 / 176^2 crops: at
   B=8 in float32 and bfloat16 with a per-layer and a per-sample scale, and
   at B=128 in bfloat16, where both are timed.
4. slice: ``HandNetPipeline`` at the fast operating point (480x640, full
   widths, seeded random weights, score threshold 0) answers three batches
   of 8 and one of 128 in bf16 through the kernels; the launch counts must
   be K1 once and K2 24 times per call. Then the float32 kernel path is
   held against the plain path on the card and against the port's own CPU
   run. Then the same for the quant_static profile (int8 convs, JAX
   package's benchmark default), calibrated on seeded frames first, with
   K3 129 times per call (113 int8 layers, the 8 tower convs at 3 levels);
   in the pipeline K3 is also held bit for bit against its plain version;
   and one batch of 8 of the dynamic quant profile.
5. throughput: frames/s at batch 128 in bf16: fast with kernels and plain
   versions, quant_static with K3 and with K3's plain version, in turns;
   then a per-stage split of fast and quant_static (CUDA events).

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
INT8_LAYERS = 113                 # QuantConvs: 49 detector + 64 A2J
INT8_LAUNCHES_PER_CALL = 129      # 105 once, the 8 tower convs at 3 FPN levels
CALIBRATION_SEEDS = (500, 501)    # two seeded batches of 8 frames
# Joints of the int8 slice, two runs whose float layers round differently
# (kernels vs plain versions, card vs CPU): an int8 conv turns a last-bit
# difference at a rounding tie into a whole quantization step, so the
# joints agree to a few hundredths of a pixel, not to 1e-4 as in float.
INT8_JOINT_TOL = 5e-2


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


def int8_geometries(dev, cfg):
    """Distinct int8 conv geometries of the int8 path at full resolution:
    ``{(h, w, cin, cout, k, stride, pad, dilation, bias): [layer names]}``,
    one name per launch in a call (from hooks on a plain-version run)."""
    import torch

    from handnet_tpu_torch.models.pipeline import HandNetPipeline
    from handnet_tpu_torch.nn.quant import QuantConv

    pipe = HandNetPipeline(cfg, dtype=torch.bfloat16, device=dev, use_kernels=False,
                           seed=SEED)
    geos = {}

    def record(name):
        def hook(m, args):
            _, _, h, w = args[0].shape
            key = (h, w, m.in_channels, m.out_channels, m.kernel_size[0], m.stride[0],
                   m.padding[0], m.dilation[0], m.bias is not None)
            geos.setdefault(key, []).append(name)
        return hook

    hooks = [m.register_forward_pre_hook(record(name)) for name, m in pipe.named_modules()
             if isinstance(m, QuantConv)]
    images, depth, _ = make_frames(1, dev, seed=400)
    pipe(images, depth)
    for h in hooks:
        h.remove()
    return geos


def k3_inputs(geo, batch: int, dtype, per_sample: bool, gen, dev, kind: str = "signed"):
    """Arguments of ``int8_conv`` for one geometry, with random int8 weights
    and scales. Activations: ``signed`` N(0, 2) (as the FPN's inputs),
    ``relu`` the same clipped at 0 (half zeros, as most int8 layers' inputs),
    or ``ties`` float32 values within an ulp of x.5 quantization steps. A
    per-layer scale sits at 0.8 of the amax, so that some values saturate."""
    import torch

    from handnet_tpu_torch.nn.quant import scale_from_amax

    h, w, cin, cout, k, s, p, d, has_bias = geo
    wq = torch.randint(-127, 128, (cout, k, k, cin), device=dev, generator=gen,
                       dtype=torch.int8)
    sw = torch.rand(cout, device=dev, generator=gen) * 1e-3 + 1e-4
    bias = torch.randn(cout, device=dev, generator=gen) if has_bias else None
    if kind == "ties":
        sx = scale_from_amax(torch.tensor(3.0, device=dev))
        steps = torch.randint(-127, 127, (batch, h, w, cin), device=dev, generator=gen)
        x = ((steps.float() + 0.5) * sx).to(dtype)
        return x, wq, sx, sw, bias, (s, s), (p, p), (d, d)
    x = torch.randn(batch, h, w, cin, device=dev, generator=gen) * 2
    x = (x.clamp_min(0) if kind == "relu" else x).to(dtype)
    amax = (x.abs().amax(dim=(1, 2, 3)).float() if per_sample
            else 0.8 * x.abs().amax().float())
    return x, wq, scale_from_amax(amax), sw, bias, (s, s), (p, p), (d, d)


def phase_int8_kernel(dev, geos):
    """K3 bit for bit against its plain version on every geometry; returns
    the JSON numbers (times at the P3 tower shape, B=128 bf16, post-ReLU
    input, per-layer scale)."""
    import torch

    from handnet_tpu_torch.ops.cuda_int8_conv import int8_conv, int8_conv_reference

    gen = torch.Generator(device=dev).manual_seed(SEED)
    checked, err = 0, 0.0

    def bitwise(name, args):
        nonlocal checked, err
        got, want = int8_conv(*args), int8_conv_reference(*args)
        if got.shape != want.shape or got.dtype != want.dtype or not torch.equal(got, want):
            diff = (got.double() - want.double()).abs()
            raise AssertionError(f"K3 {name}: not bit-equal to its plain version "
                                 f"({int((diff > 0).sum())} elements differ, max "
                                 f"{diff.max().item():.3e})")
        checked += 1
        err = max(err, (got.double() - want.double()).abs().max().item())

    p3_tower = (60, 80, 256, 256, 3, 1, 1, 1, True)
    totals = {"kernel": 0.0, "plain": 0.0}
    for geo, names in sorted(geos.items(), key=lambda kv: kv[1][0]):
        h, w, cin, cout, k, s, p, d, has_bias = geo
        label = (f"{names[0]} x{len(names)}: {h}x{w}x{cin}->{cout} {k}x{k} s{s} p{p} d{d}"
                 f"{' +bias' if has_bias else ''}")
        for dtype in (torch.float32, torch.bfloat16):
            for per_sample in (False, True):
                bitwise(f"{label} B=8 {dtype} per_sample={per_sample}",
                        k3_inputs(geo, 8, dtype, per_sample, gen, dev))
        bitwise(f"{label} B=8 f32 near ties",
                k3_inputs(geo, 8, torch.float32, False, gen, dev, kind="ties"))
        args = k3_inputs(geo, 128, torch.bfloat16, False, gen, dev, kind="relu")
        bitwise(f"{label} B=128 bf16 relu", args)
        if geo == p3_tower:
            for dtype, per_sample in ((torch.bfloat16, True), (torch.float32, False),
                                      (torch.float32, True)):
                bitwise(f"{label} B=128 {dtype} per_sample={per_sample}",
                        k3_inputs(geo, 128, dtype, per_sample, gen, dev))
        kt = cuda_ms(lambda: int8_conv(*args), iters=10, warmup=2)
        pt = cuda_ms(lambda: int8_conv_reference(*args), iters=10, warmup=2)
        del args
        ho, wo = (h + 2 * p - d * (k - 1) - 1) // s + 1, (w + 2 * p - d * (k - 1) - 1) // s + 1
        tops = 2 * 128 * ho * wo * cout * k * k * cin / (kt * 1e-3) / 1e12
        totals["kernel"] += kt * len(names)
        totals["plain"] += pt * len(names)
        if geo == p3_tower:
            p3 = (kt, pt)
        log("kernels", f"K3 int8_conv {label}: B=8 f32/bf16 x per-layer/per-sample sx, "
            f"B=8 f32 near ties and B=128 bf16 bit-equal; B=128 bf16 post-ReLU input, "
            f"per-layer sx: kernel {kt:.4f} ms ({tops:.1f} TOP/s), plain {pt:.4f} ms")
    log("kernels", f"K3: {len(geos)} geometries, {checked} bit-equal comparisons; per "
        f"B=128 call ({sum(map(len, geos.values()))} launches): kernel "
        f"{totals['kernel']:.2f} ms, plain {totals['plain']:.2f} ms (sum of the "
        "per-geometry times)")
    return {"max_abs_err": err, "ms": p3[0], "plain_ms": p3[1]}


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
        g, w = got[key].cpu(), want[key].cpu()
        if not torch.equal(g, w):
            frames = [i for i in range(len(g)) if not torch.equal(g[i], w[i])]
            raise AssertionError(f"{name}: {key} differ on frames {frames}; boxes "
                                 f"{got['boxes'].cpu()[frames].tolist()} vs "
                                 f"{want['boxes'].cpu()[frames].tolist()}")
    err = 0.0
    for key, scale in (("joints_uvd", 1.0), ("joints_uvd_full", 1.0), ("joints_xyz", 10.0)):
        err = max(err, check(f"{name} {key}", got[key].cpu(), want[key].cpu(),
                             joint_tol * scale))
    return err


def phase_slice(dev, cfg):
    import torch

    from handnet_tpu_torch.models.pipeline import HandNetPipeline

    crop, joints = cfg.pipeline.crop_size, cfg.a2j.num_joints
    pipe = HandNetPipeline(cfg, dtype=torch.bfloat16, device=dev, seed=SEED)
    requests = [make_frames(bsz, dev, seed=100 + i) for i, bsz in enumerate(SLICE_REQUESTS)]
    torch.cuda.synchronize()

    reset_launch_counts()
    start = time.perf_counter()
    outs = [pipe(*req) for req in requests]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = launch_counts()
    for out, bsz in zip(outs, SLICE_REQUESTS):
        check_outputs(out, bsz, crop, joints)
    calls = len(SLICE_REQUESTS)
    if launches != {"gn_group_stats": GN_LAYERS_PER_CALL * calls, "a2j_decode": calls,
                    "int8_conv": 0}:
        raise AssertionError(f"launch counts {launches} for {calls} calls: expected "
                             f"K2 {GN_LAYERS_PER_CALL} and K1 1 per call, no K3")
    log("slice", f"fast bf16 calls of batch {list(SLICE_REQUESTS)} in {seconds:.3f} s (first "
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
    log("slice", f"fast f32 batch 8: kernel path == plain path on found/sides/boxes/crops; "
        f"joints max|err| {err_plain:.3e} (tol 1e-2 px, 1e-1 mm)")
    cpu = HandNetPipeline(cfg, device="cpu", seed=SEED)
    out_c = cpu(images[:2].cpu(), depth[:2].cpu(), paras[:2].cpu())
    del cpu
    err_cpu = compare_outputs("card vs CPU (f32)", {k: v[:2] for k, v in out_k.items()},
                              out_c, 5e-2)
    log("slice", f"fast f32 2 frames: card kernel path == CPU run on found/sides/boxes/crops; "
        f"joints max|err| {err_cpu:.3e} (tol 5e-2 px, 5e-1 mm)")
    torch.backends.cudnn.allow_tf32 = True
    return launches


def launch_counts():
    from handnet_tpu_torch.ops.cuda_a2j import a2j_decode
    from handnet_tpu_torch.ops.cuda_gn import gn_group_stats
    from handnet_tpu_torch.ops.cuda_int8_conv import int8_conv

    return {"a2j_decode": a2j_decode.launches, "gn_group_stats": gn_group_stats.launches,
            "int8_conv": int8_conv.launches}


def reset_launch_counts() -> None:
    from handnet_tpu_torch.ops.cuda_a2j import a2j_decode
    from handnet_tpu_torch.ops.cuda_gn import gn_group_stats
    from handnet_tpu_torch.ops.cuda_int8_conv import int8_conv

    a2j_decode.launches = gn_group_stats.launches = int8_conv.launches = 0


def set_int8_kernel(pipe, on: bool) -> None:
    """Route every QuantConv of ``pipe`` through K3 (True) or its plain
    version (False); K1 and K2 are left as they are."""
    from handnet_tpu_torch.nn.quant import QuantConv

    for m in pipe.modules():
        if isinstance(m, QuantConv):
            m.use_kernel = on


def calibrated_pipeline(dev, cfg, dtype):
    """A quant_static pipeline calibrated on two seeded batches of 8."""
    from handnet_tpu_torch.models.pipeline import HandNetPipeline
    from handnet_tpu_torch.nn.quant import assert_calibrated

    pipe = HandNetPipeline(cfg, dtype=dtype, device=dev, seed=SEED)
    frames = [make_frames(8, dev, seed) for seed in CALIBRATION_SEEDS]
    pipe.calibrate([f[0] for f in frames], [f[1] for f in frames])
    assert_calibrated(pipe)
    return pipe


def phase_quant_slice(dev, cfg, cfg_dynamic):
    """The quant_static slice through K1, K2 and K3; returns the launch
    counts of its requests (the main path's run)."""
    import torch

    from handnet_tpu_torch.models.pipeline import HandNetPipeline

    crop, joints = cfg.pipeline.crop_size, cfg.a2j.num_joints
    start = time.perf_counter()
    pipe = calibrated_pipeline(dev, cfg, torch.bfloat16)
    torch.cuda.synchronize()
    log("slice", f"quant_static bf16: calibrated on 2 x 8 seeded frames in "
        f"{time.perf_counter() - start:.3f} s; {INT8_LAYERS} act_amax set, assert_calibrated "
        "passes")
    requests = [make_frames(bsz, dev, seed=100 + i) for i, bsz in enumerate(SLICE_REQUESTS)]
    torch.cuda.synchronize()

    reset_launch_counts()
    start = time.perf_counter()
    outs = [pipe(*req) for req in requests]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = launch_counts()
    for out, bsz in zip(outs, SLICE_REQUESTS):
        check_outputs(out, bsz, crop, joints)
    calls = len(SLICE_REQUESTS)
    expected = {"a2j_decode": calls, "gn_group_stats": GN_LAYERS_PER_CALL * calls,
                "int8_conv": INT8_LAUNCHES_PER_CALL * calls}
    if launches != expected:
        raise AssertionError(f"quant_static launch counts {launches}, expected {expected}")
    log("slice", f"quant_static bf16 calls of batch {list(SLICE_REQUESTS)} in {seconds:.3f} s "
        f"(first calls): all frames found, outputs finite; launches {launches}")

    # in the pipeline, K3 against its plain version: every output bit-equal
    set_int8_kernel(pipe, False)
    out_plain = pipe(*requests[0])
    set_int8_kernel(pipe, True)
    for key, value in outs[0].items():
        if not torch.equal(value, out_plain[key]):
            raise AssertionError(f"quant_static bf16: {key} differs between K3 and its "
                                 "plain version")
    log("slice", "quant_static bf16 batch 8: every output bit-equal with K3's plain version "
        "in place of K3")
    del pipe, outs, requests, out_plain

    # float32, TF32 off: K3 against its plain version (bit-equal), the whole
    # kernel path against the plain path, and the card against the CPU
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    images, depth, paras = make_frames(8, dev, seed=200)
    kern = calibrated_pipeline(dev, cfg, torch.float32)
    state = {k: v.cpu() for k, v in kern.state_dict().items()}
    out_k = kern(images, depth, paras)
    set_int8_kernel(kern, False)
    out_k3p = kern(images, depth, paras)
    del kern
    for key, value in out_k.items():
        if not torch.equal(value, out_k3p[key]):
            raise AssertionError(f"quant_static f32: {key} differs between K3 and its "
                                 "plain version")
    plain = HandNetPipeline(cfg, device=dev, use_kernels=False, seed=SEED)
    plain.load_state_dict(state)
    out_p = plain(images, depth, paras)
    del plain
    err_plain = compare_outputs("quant_static kernels vs plain (card, f32)", out_k, out_p,
                                INT8_JOINT_TOL)
    log("slice", f"quant_static f32 batch 8: K3 path == K3-plain path bit for bit; kernel "
        f"path == plain path on found/sides/boxes/crops, joints max|err| {err_plain:.3e} "
        f"(tol {INT8_JOINT_TOL} px, {10 * INT8_JOINT_TOL} mm)")
    cpu = HandNetPipeline(cfg, device="cpu", seed=SEED)
    cpu.load_state_dict(state)
    out_c = cpu(images[:2].cpu(), depth[:2].cpu(), paras[:2].cpu())
    del cpu
    err_cpu = compare_outputs("quant_static card vs CPU (f32)",
                              {k: v[:2] for k, v in out_k.items()}, out_c, INT8_JOINT_TOL)
    log("slice", f"quant_static f32 2 frames: card == CPU run on found/sides/boxes/crops; "
        f"joints max|err| {err_cpu:.3e} (tol {INT8_JOINT_TOL} px, {10 * INT8_JOINT_TOL} mm)")
    torch.backends.cudnn.allow_tf32 = True

    # the dynamic profile: per-sample scales, no calibration
    dyn = HandNetPipeline(cfg_dynamic, dtype=torch.bfloat16, device=dev, seed=SEED)
    reset_launch_counts()
    frames = make_frames(8, dev, seed=600)
    out = dyn(*frames)
    torch.cuda.synchronize()
    check_outputs(out, len(frames[0]), crop, joints)
    counts = launch_counts()
    if counts["int8_conv"] != INT8_LAUNCHES_PER_CALL:
        raise AssertionError(f"quant (dynamic): launch counts {counts}")
    log("slice", f"quant (dynamic) bf16 batch 8: all frames found, outputs finite; "
        f"launches {counts}")
    return launches


def phase_throughput(dev, cfg, cfg_quant) -> None:
    """frames/s at B=128 in bf16, in turns: fast with kernels and with the
    plain versions, quant_static with K3 and with K3's plain version."""
    import torch

    from handnet_tpu_torch.models.pipeline import HandNetPipeline

    images, depth, paras = make_frames(128, dev, seed=300)
    fast = {"fast kernels": HandNetPipeline(cfg, dtype=torch.bfloat16, device=dev, seed=SEED),
            "fast plain": HandNetPipeline(cfg, dtype=torch.bfloat16, device=dev,
                                          use_kernels=False, seed=SEED)}
    quant = calibrated_pipeline(dev, cfg_quant, torch.bfloat16)
    iters = 10
    names = ("fast kernels", "fast plain", "quant_static kernels", "quant_static K3 plain")
    fps = {name: [] for name in names}
    for name in names + names[::-1]:
        pipe = fast.get(name, quant)
        if pipe is quant:
            set_int8_kernel(quant, name == "quant_static kernels")
        for _ in range(2):
            pipe(images, depth, paras)
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(iters):
            pipe(images, depth, paras)
        torch.cuda.synchronize()
        fps[name].append(128 * iters / (time.perf_counter() - start))
    set_int8_kernel(quant, True)
    for name, vals in fps.items():
        log("throughput", f"bf16 batch 128, {name}: "
            + ", ".join(f"{v:.2f}" for v in vals) + " frames/s "
            f"(mean {sum(vals) / len(vals):.2f}; {iters} calls per run, "
            "host clock around synchronize)")
    log("throughput", f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    stage_split(fast["fast kernels"], quant, images, depth)


def stage_split(fast, quant, images, depth) -> None:
    """ms per stage at B=128 bf16 (CUDA events, 5 calls after 2), each
    stage run alone on the previous stage's output."""
    from handnet_tpu_torch.models.a2j import a2j_postprocess
    from handnet_tpu_torch.models.fcos import decode_detections, preprocess

    for name, pipe in (("fast", fast), ("quant_static", quant)):
        det = pipe.detector
        net_in, scale = preprocess(images, det.cfg)
        head = det(net_in)
        stage = pipe._detect_and_crop(images, depth)
        heads = pipe.a2j(stage["crops"])
        times = {
            "preprocess": cuda_ms(lambda: preprocess(images, det.cfg), 5, 2),
            "detector network": cuda_ms(lambda: det(net_in), 5, 2),
            "decode + NMS": cuda_ms(lambda: decode_detections(head, det.anchors, det.cfg,
                                                              scale_to_original=scale), 5, 2),
            "A2J network": cuda_ms(lambda: pipe.a2j(stage["crops"]), 5, 2),
            "A2J decode": cuda_ms(lambda: a2j_postprocess(heads, pipe.a2j.anchors), 5, 2),
            "whole forward": cuda_ms(lambda: pipe(images, depth), 5, 2),
        }
        log("throughput", f"stage split, {name} kernels, bf16 B=128 (ms): "
            + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))


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

    from handnet_tpu_torch.config import FAST, QUANT, QUANT_STATIC, load_config
    from handnet_tpu_torch.kernels import build

    res = build.build_library()
    build.load_library()
    log("build", f"{res.path.name} in {res.seconds:.2f} s (0 = already built)")
    for line in res.log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            log("build", line.strip())

    def profile(overrides):  # score threshold 0: every frame takes the found path
        cfg = load_config(overrides=overrides)
        return dataclasses.replace(cfg, fcos=dataclasses.replace(cfg.fcos, score_thresh=0.0))

    cfg, cfg_quant, cfg_dynamic = profile(FAST), profile(QUANT_STATIC), profile(QUANT)

    results = phase_kernels(dev)
    geos = int8_geometries(dev, cfg_dynamic)
    if (sum(map(len, geos.values())) != INT8_LAUNCHES_PER_CALL
            or len({n for names in geos.values() for n in names}) != INT8_LAYERS):
        raise AssertionError(f"int8 path: {len(geos)} geometries, unexpected layer counts")
    results["int8_conv"] = phase_int8_kernel(dev, geos)

    phase_slice(dev, cfg)
    # the main path of this script: every kernel runs in the quant_static slice
    launches = phase_quant_slice(dev, cfg_quant, cfg_dynamic)
    phase_throughput(dev, cfg, cfg_quant)

    sources = {"a2j_decode": ("handnet_tpu_torch/csrc/a2j_decode.cu",
                              "handnet_tpu/ops/pallas_a2j.py:55"),
               "gn_group_stats": ("handnet_tpu_torch/csrc/gn_stats.cu",
                                  "handnet_tpu/ops/pallas_gn.py:138"),
               "int8_conv": ("handnet_tpu_torch/csrc/int8_conv.cu",
                             "handnet_tpu/nn/quant.py:139")}
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
