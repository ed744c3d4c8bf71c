"""The parity and turbo geometries of the PyTorch port against the JAX
package: the matmul resize and ``preprocess``'s resize branch, the
space-to-depth stem, the fused-tower head, the 100DOH extension heads, the
2-conv (turbo) towers, the ``PARITY``/``TURBO`` profiles and
``resolve_config``, and the whole slice, ``detect()`` and ``pose()`` on
frames that the detector resamples.

Both sides run in float32 on the CPU with the same numpy inputs and weights.
Tolerances: resize matrices bit for bit (the same numpy code); resized and
normalized frames to rtol 1e-5 (float32 sums of the same taps in another
order); the stem to 1e-5 of scale in float32 (the JAX package's own
s2d-equivalence tolerance: the same products summed in another order) and
to 1e-2 of scale in bfloat16 (both convs round their outputs to bf16, one
ulp is 2^-8 of the value); networks to rtol 1e-4 with a floor of 1e-4 of
the output's scale, as ``test_torch_port_modules.py``; decode and crops
exactly.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handnet_tpu import config as jconfig
from handnet_tpu.convert.torch_weights import convert_a2j, convert_fcos
from handnet_tpu.models import fcos as jfcos
from handnet_tpu.models.pipeline import HandNetPipeline as JaxPipeline
from handnet_tpu.nn.resnet import StemConv as JStemConv
from handnet_tpu.ops import anchors as janchors
from handnet_tpu.ops import resize as jresize
from handnet_tpu_torch import config as pconfig
from handnet_tpu_torch.convert.from_flax import (fcos_state_dict_from_flax,
                                                 pipeline_state_dict_from_flax)
from handnet_tpu_torch.models import fcos as pfcos
from handnet_tpu_torch.models.pipeline import HandNetPipeline
from handnet_tpu_torch.nn.resnet import StemConv, init_conv_weights_
from handnet_tpu_torch.ops import cuda_gn
from handnet_tpu_torch.ops import resize as presize
from torch_port_fixtures import assert_close, leaves_equal, nhwc, randomize_norms

REPO = Path(__file__).resolve().parent.parent
IMAGE_H, IMAGE_W, CROP, WIDTH = 64, 96, 48, 64
H100_SMS = 132


def _close_to(got, want, err_msg=""):
    want = np.asarray(want)
    assert_close(got, want, rtol=1e-4, atol=1e-4 * max(1.0, float(np.abs(want).max())),
                 err_msg=err_msg)


def _fcos_cfg(module, **kw):
    base = dict(num_classes=3, ext=False, image_h=IMAGE_H, image_w=IMAGE_W,
                max_detections=8)
    return module.FCOSConfig(**{**base, **kw})


# ---------------------------------------------------------------------------
# resize and preprocess


@pytest.mark.parametrize("in_size,out_size,padded", [
    (48, 64, None),        # upscale
    (64, 40, None),        # downscale: the antialias widening
    (48, 64, 72),          # upscale with the fused pad
    (640, 1067, 1088),     # parity, along W
    (480, 800, 800),       # parity, along H
])
def test_resize_matrix_bit_equal(in_size, out_size, padded):
    want = jresize._resize_matrix(in_size, out_size, padded)
    got = presize._resize_matrix(in_size, out_size, padded)
    assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)


@pytest.mark.parametrize("size,out_hw,padded", [
    ((30, 40), (48, 64), None),
    ((30, 40), (64, 85), (64, 96)),
    ((64, 96), (40, 60), (48, 64)),
])
def test_resize_bilinear_matmul_matches_jax(size, out_hw, padded):
    images = np.random.default_rng(20).normal(size=(2, *size, 3)).astype(np.float32)
    want = jresize.resize_bilinear_matmul(jnp.asarray(images), *out_hw, padded_hw=padded)
    got = presize.resize_bilinear_matmul(torch.from_numpy(images), *out_hw,
                                         padded_hw=padded)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert_close(got, want, rtol=1e-5, atol=1e-6)
    if padded:
        assert not got[:, out_hw[0]:].any() and not got[:, :, out_hw[1]:].any()


@pytest.mark.parametrize("size", [(30, 40), (100, 160)])   # up, and down (antialias)
@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_preprocess_resize_branch_matches_jax(size, dtype):
    rng = np.random.default_rng(21)
    shape = (2, *size, 3)
    frames = (rng.integers(0, 256, size=shape, dtype=np.uint8) if dtype == "uint8"
              else rng.uniform(size=shape).astype(np.float32))
    want, want_scale = jfcos.preprocess(jnp.asarray(frames), _fcos_cfg(jconfig))
    got, got_scale = pfcos.preprocess(torch.from_numpy(frames), _fcos_cfg(pconfig))
    assert got_scale == want_scale
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert_close(got, want, rtol=1e-5, atol=1e-5)
    scale = min(IMAGE_H / size[0], IMAGE_W / size[1])
    new_h, new_w = round(size[0] * scale), round(size[1] * scale)
    assert (new_h, new_w) != size and (new_h, new_w) != (IMAGE_H, IMAGE_W)
    assert not got[:, new_h:].any() and not got[:, :, new_w:].any()   # the pad: exact zeros


# ---------------------------------------------------------------------------
# space-to-depth stem


@pytest.mark.parametrize("hw", [(64, 96), (63, 96)])   # even; odd H falls back
def test_s2d_stem_matches_flax_and_plain_stem(hw):
    rng = np.random.default_rng(22)
    x = rng.normal(size=(2, *hw, 3)).astype(np.float32)
    stem = JStemConv(width=16, s2d=True)
    v = stem.init(jax.random.PRNGKey(3), jnp.asarray(x))
    want = np.asarray(stem.apply(v, jnp.asarray(x)))
    weight = torch.from_numpy(np.asarray(v["params"]["kernel"]).transpose(3, 2, 0, 1).copy())
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    outs = {}
    for s2d in (True, False):
        conv = StemConv(3, 16, s2d=s2d)
        conv.load_state_dict({"weight": weight}, strict=True)
        with torch.no_grad():
            outs[s2d] = conv(xt)
    tol = 1e-5 * max(1.0, float(np.abs(want).max()))
    assert_close(nhwc(outs[True]), want, rtol=1e-5, atol=tol)
    assert_close(outs[True], outs[False], rtol=1e-5, atol=tol)
    if hw[0] % 2:
        assert torch.equal(outs[True], outs[False])   # the plain conv itself


def test_s2d_stem_bf16_matches_plain_stem():
    torch.manual_seed(0)
    conv = StemConv(3, 64, s2d=True).to(torch.bfloat16, memory_format=torch.channels_last)
    x = torch.randn(2, 3, 64, 96).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    with torch.no_grad():
        s2d = conv(x)
        conv.s2d = False
        plain = conv(x)
    assert s2d.dtype == torch.bfloat16 and s2d.shape == plain.shape == (2, 64, 32, 48)
    assert_close(s2d.float(), plain.float(), rtol=0,
                 atol=1e-2 * float(plain.float().abs().max()))


# ---------------------------------------------------------------------------
# heads: extension heads, turbo towers, fused towers


@pytest.fixture(scope="module", params=[(4, True), (2, False)], ids=["ext", "turbo"])
def head_case(request):
    """A narrow head (64 channels, 32 groups) of ``num_convs`` tower layers,
    with or without the extension heads: flax variables (the port's seeded
    init through the JAX converter, random norms), the JAX outputs of the
    unfused head and of ``FCOSHead(fused_towers=True)``, and the port's
    FCOSHead loaded from the same variables."""
    num_convs, ext = request.param
    kw = dict(fpn_channels=WIDTH, num_convs=num_convs, ext=ext)
    rng = np.random.default_rng(23)
    feats = [rng.normal(1.0, 2.0, size=(2, h, w, WIDTH)).astype(np.float32)
             for h, w in ((8, 12), (4, 6), (2, 3))]
    jfeats = [jnp.asarray(f) for f in feats]
    init = pfcos.FCOSHead(_fcos_cfg(pconfig, **kw))
    init_conv_weights_(init, torch.Generator().manual_seed(4))
    tree = convert_fcos({f"head.{k}": t.numpy() for k, t in init.state_dict().items()})
    v = randomize_norms({"params": tree["params"]["head"]}, seed=8)
    want = {k: np.asarray(t) for k, t in
            jax.jit(jfcos.FCOSHead(cfg=_fcos_cfg(jconfig, **kw)).apply)(v, jfeats).items()}
    fused = jfcos.FCOSHead(cfg=_fcos_cfg(jconfig, **kw), fused_towers=True)
    want_fused = {k: np.asarray(t) for k, t in jax.jit(fused.apply)(v, jfeats).items()}
    sd = fcos_state_dict_from_flax({"params": {"head": v["params"]}})
    net = pfcos.FCOSHead(_fcos_cfg(pconfig, **kw))
    net.load_state_dict({k[len("head."):]: t for k, t in sd.items()}, strict=True)
    feats_t = [torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats]
    return {"kw": kw, "vars": v, "sd": sd, "want": want, "want_fused": want_fused,
            "net": net, "feats": feats_t}


def test_head_matches_flax(head_case):
    """Every output key, extension heads included (ext) or 2-conv towers
    (turbo)."""
    with torch.no_grad():
        got = head_case["net"](head_case["feats"])
    want = head_case["want"]
    assert sorted(got) == sorted(want)
    if head_case["kw"]["ext"]:
        assert {"hand_contact_state", "hand_dxdy"} <= set(got)
        vec = got["hand_dxdy"][..., 1:].norm(dim=-1)
        assert bool(((vec - 0.1).abs() < 1e-5).logical_or(vec == 0).all())
    for key in want:
        _close_to(got[key], want[key], err_msg=key)


def test_fused_towers_match_flax_and_unfused(head_case):
    """The port's fused head (one tower of 128 channels, GroupNorm of 64
    groups, 2-group convs) against JAX's *unfused* head and the port's own
    unfused head; the flag is read at forward time.

    JAX's fused head (``FCOSHead(fused_towers=True)``) computes something
    else, and the test pins that: its ``_group_norm``
    (``handnet_tpu/models/fcos.py:70-77``) takes the mean and variance over
    each pixel's C/G channels only, not over (H, W, C/G), so it normalizes
    every pixel's group on its own. The port keeps GroupNorm's meaning,
    which the unfused heads of both packages share."""
    net = head_case["net"]
    with torch.no_grad():
        unfused = net(head_case["feats"])
        net.fused_towers = True
        try:
            fused = net(head_case["feats"])
        finally:
            net.fused_towers = False
    want = head_case["want"]
    assert sorted(fused) == sorted(want) == sorted(head_case["want_fused"])
    for key in want:
        _close_to(fused[key], want[key], err_msg=key)
        _close_to(fused[key], unfused[key].numpy(), err_msg=key)
    jax_gap = max(float(np.abs(head_case["want_fused"][key] - want[key]).max())
                  for key in want)
    assert jax_gap > 0.1, jax_gap


def test_fused_towers_refuse_int8_towers():
    head = pfcos.FCOSHead(_fcos_cfg(pconfig, fpn_channels=WIDTH, quant=True))
    head.fused_towers = True
    feats = [torch.zeros(1, WIDTH, s, s) for s in (4, 2, 1)]
    with pytest.raises(ValueError, match="fused_towers"):
        head(feats)


def test_head_weights_round_trip(head_case):
    """flax -> port -> flax gives back every leaf of the head exactly, the
    extension heads' included where there are some."""
    sd = head_case["sd"]
    ext_keys = {"head.classification_head.hand_contact_state_layer.weight",
                "head.classification_head.hand_dydx_layer.bias"}
    assert (ext_keys <= set(sd)) == head_case["kw"]["ext"]
    back = convert_fcos({k: t.numpy() for k, t in sd.items()})
    assert leaves_equal(back["params"], {"head": head_case["vars"]["params"]})


def test_flax_tree_loads_into_every_variant():
    """One flax tree (the JAX converter's output for a plain port FCOS)
    loads strictly into the s2d-stem FCOS, whose forward equals the plain
    stem's, and into the fused-tower head, whose forward equals the
    unfused head's: neither variant has keys of its own."""
    plain = pfcos.FCOS(_fcos_cfg(pconfig, fpn_channels=WIDTH))
    plain.init_weights_(torch.Generator().manual_seed(5))
    tree = convert_fcos({k: t.numpy() for k, t in plain.state_dict().items()})
    variant = pfcos.FCOS(_fcos_cfg(pconfig, fpn_channels=WIDTH, s2d_stem=True))
    variant.load_state_dict(fcos_state_dict_from_flax(tree), strict=True)
    variant.head.fused_towers = True
    x = torch.from_numpy(np.random.default_rng(24).normal(
        size=(2, IMAGE_H, IMAGE_W, 3)).astype(np.float32))
    with torch.no_grad():
        want, got = plain(x), variant(x)
    for key in want:
        _close_to(got[key], want[key].numpy(), err_msg=key)


def test_decode_detections_ext_exact():
    """Same head tensors on both sides, extension heads included: equal keep
    masks, and equal labels, sides, boxes, contacts and dxdymags under it."""
    anchors = janchors.fcos_anchor_pyramid(IMAGE_H, IMAGE_W)[0]
    rng = np.random.default_rng(25)
    n = anchors.shape[0]
    head = {"cls_logits": rng.normal(size=(3, n, 3)).astype(np.float32),
            "hand_lr": rng.normal(size=(3, n, 2)).astype(np.float32),
            "hand_contact_state": rng.normal(size=(3, n, 5)).astype(np.float32),
            "hand_dxdy": rng.normal(size=(3, n, 3)).astype(np.float32),
            "bbox_regression": rng.uniform(0.5, 3.0, size=(3, n, 4)).astype(np.float32),
            "bbox_ctrness": rng.normal(size=(3, n, 1)).astype(np.float32)}
    cfg_j, cfg_p = (_fcos_cfg(jconfig, ext=True, score_thresh=0.55, max_detections=16),
                    _fcos_cfg(pconfig, ext=True, score_thresh=0.55, max_detections=16))
    want = jax.jit(lambda h, a: jfcos.decode_detections(h, a, cfg_j, (1.5, 2.0)))(
        {k: jnp.asarray(v) for k, v in head.items()}, jnp.asarray(anchors))
    got = pfcos.decode_detections({k: torch.from_numpy(v) for k, v in head.items()},
                                  torch.from_numpy(anchors), cfg_p,
                                  scale_to_original=(1.5, 2.0))
    assert sorted(got) == sorted(want)
    keep = np.asarray(want["valid"])
    assert np.array_equal(got["valid"].numpy(), keep) and 0 < keep.sum() < keep.size
    assert tuple(got["dxdymags"].shape) == (3, 16, 3)
    for key in ("labels", "sides", "boxes", "contacts", "dxdymags"):
        assert np.array_equal(got[key].numpy()[keep], np.asarray(want[key])[keep]), key


# ---------------------------------------------------------------------------
# profiles


@pytest.mark.parametrize("name", ["parity", "turbo"])
def test_parity_and_turbo_dicts_equal_their_yaml(name):
    got = pconfig.load_config(overrides=getattr(pconfig, name.upper()))
    want = jconfig.load_config(yaml_path=str(REPO / "configs" / f"{name}.yaml"))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("quant,env", [(None, None), (True, "1"), ("static", "static")])
def test_resolve_config_equals_bench(quant, env):
    """``resolve_config(profile, quant)`` is bench.py's PROFILE/QUANT
    composition, for every profile that has a dict."""
    import bench

    for profile in pconfig.PROFILES:
        environ = {"PROFILE": profile, **({"QUANT": env} if env else {})}
        want = dataclasses.asdict(bench.resolve_config(env=environ))
        assert dataclasses.asdict(pconfig.resolve_config(profile, quant)) == want, profile
    with pytest.raises(ValueError):
        pconfig.resolve_config("fast", quant="dynamic")


def test_c512_row_plans_cover_hw():
    """The fused towers' GroupNorm (C=512, G=64: C/G = 8) at the native and
    parity FPN levels: whole pixel rows, at least G threads, every pixel
    covered once, and K2s's walk and fold still equal to the plain version."""
    for hw in (4800, 1200, 300, 13600, 3400, 850):
        for itemsize in (2, 4):
            for batch in (1, 8, 128):
                plan = cuda_gn.row_plan(batch, hw, 512, itemsize, H100_SMS,
                                        cuda_gn.STATS_UNROLL, cuda_gn.STATS_BLOCKS_PER_SM)
                assert plan.cp * 16 == 512 * itemsize and plan.rows * plan.cp >= 64
                assert (plan.splits - 1) * plan.per_split < hw <= plan.splits * plan.per_split
    x = torch.from_numpy(np.random.default_rng(26).normal(2.0, 3.0, size=(2, 25, 34, 512))
                         .astype(np.float32))
    for dtype in (torch.float32, torch.bfloat16):
        xd = x.to(dtype)
        plan = cuda_gn.row_plan(128, 850, 512, xd.element_size(), H100_SMS,
                                cuda_gn.STATS_UNROLL, cuda_gn.STATS_BLOCKS_PER_SM)
        got = cuda_gn.gn_stats_split_emulation(xd, 64, plan)
        want = cuda_gn.gn_group_stats_reference(xd, 64)
        assert_close(got, want, rtol=0, atol=1e-4 * float(want.abs().max()))


# ---------------------------------------------------------------------------
# the slice on resampled frames, detect() and pose()

FRAME_H, FRAME_W = 48, 64    # -> 64x85, padded to 64x96


def _slice_cfg(module):
    return module.HandNetConfig(
        a2j=module.A2JConfig(crop_h=CROP, crop_w=CROP),
        fcos=_fcos_cfg(module, ext=True, fpn_channels=WIDTH, score_thresh=0.0),
        pipeline=module.PipelineConfig(crop_size=CROP))


@pytest.fixture(scope="module")
def resampled_slice():
    """Port and JAX outputs of the whole slice, ``detect`` and ``pose`` on
    the same 48x64 frames and crops, with one set of weights (the port's
    seeded init with random norms, through the JAX package's converters)."""
    sd = {k: v.numpy() for k, v in HandNetPipeline(_slice_cfg(pconfig), seed=6, device="cpu")
          .state_dict().items()}
    flax_vars = {
        "detector": randomize_norms(convert_fcos(
            {k[len("detector."):]: v for k, v in sd.items() if k.startswith("detector.")}),
            seed=4),
        "a2j": randomize_norms(convert_a2j(
            {k[len("a2j."):]: v for k, v in sd.items() if k.startswith("a2j.")}), seed=5),
    }
    rng = np.random.default_rng(27)
    images = rng.uniform(size=(2, FRAME_H, FRAME_W, 3)).astype(np.float32)
    depth = rng.uniform(0.3, 1.0, size=(2, FRAME_H, FRAME_W)).astype(np.float32)
    paras = np.tile([600.0, 600.0, FRAME_W / 2, FRAME_H / 2], (2, 1)).astype(np.float32)
    crops = rng.uniform(0.3, 1.0, size=(2, CROP, CROP, 1)).astype(np.float32)
    port = HandNetPipeline(_slice_cfg(pconfig), device="cpu")
    port.load_state_dict(pipeline_state_dict_from_flax(flax_vars), strict=True)
    t = torch.from_numpy
    got = (port(t(images), t(depth), t(paras)), port.detect(t(images)), port.pose(t(crops)))
    jax_pipe = JaxPipeline(_slice_cfg(jconfig))
    want = jax.jit(lambda v, im, d, p, c: (jax_pipe(v, im, d, p), jax_pipe.detect(v, im),
                                            jax_pipe.pose(v, c)))(
        jax.tree_util.tree_map(jnp.asarray, flax_vars),
        *(jnp.asarray(a) for a in (images, depth, paras, crops)))
    return ({k: v.numpy() for k, v in got[0].items()}, {k: np.asarray(v) for k, v in want[0].items()},
            {k: v.numpy() for k, v in got[1].items()}, {k: np.asarray(v) for k, v in want[1].items()},
            got[2].numpy(), np.asarray(want[2]))


def test_slice_on_resampled_frames_matches_jax(resampled_slice):
    """Every output key; tolerances as ``test_torch_port_pipeline.py``'s
    found path (crop boxes and crops exact, scores 1e-5, joints 1e-3 px)."""
    got, want = resampled_slice[:2]
    assert sorted(got) == sorted(want)
    assert want["found"].all()
    for key in ("found", "sides", "boxes", "crops"):
        assert got[key].shape == want[key].shape and np.array_equal(got[key], want[key]), key
    assert_close(got["scores"], want["scores"], rtol=1e-5, atol=1e-6)
    for key in ("joints_uvd", "joints_uvd_full"):
        assert_close(got[key], want[key], rtol=1e-4, atol=1e-3, err_msg=key)
    assert_close(got["joints_xyz"], want["joints_xyz"], rtol=1e-4, atol=1e-2)


def test_detect_matches_jax(resampled_slice):
    """Detections in frame pixels, extension heads included: equal keep
    masks, labels, sides and contacts; boxes (scaled back by 48/64) and
    dxdymags to float32 tolerance."""
    got, want = resampled_slice[2:4]
    assert sorted(got) == sorted(want)
    assert np.array_equal(got["valid"], want["valid"]) and want["valid"].any()
    for key in ("labels", "sides", "contacts"):
        assert np.array_equal(got[key], want[key]), key
    assert_close(got["scores"], want["scores"], rtol=1e-5, atol=1e-6)
    assert_close(got["boxes"], want["boxes"], rtol=1e-4, atol=1e-3)
    assert_close(got["dxdymags"], want["dxdymags"], rtol=1e-4, atol=1e-5)


def test_pose_matches_jax(resampled_slice):
    got, want = resampled_slice[4:]
    assert got.shape == want.shape == (2, 21, 3)
    assert_close(got, want, rtol=1e-4, atol=1e-3)
