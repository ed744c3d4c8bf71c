"""Modules of the PyTorch port (``handnet_tpu_torch``) against their JAX
counterparts in ``handnet_tpu``, fed the same numpy inputs and the same
weights (flax variables -> ``convert/from_flax.py`` -> ``load_state_dict``).

Both sides run in float32 on the CPU. Tolerances: networks to rtol 1e-4 with
an absolute floor of 1e-4 of the output's scale (the two frameworks sum
convolutions in different orders; observed differences are ~1e-6
relative); decode, pad and crop exactly.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handnet_tpu.config import A2JConfig, FCOSConfig
from handnet_tpu.convert.torch_weights import convert_a2j, convert_fcos
from handnet_tpu.models import a2j as ja2j
from handnet_tpu.models import fcos as jfcos
from handnet_tpu.nn.fpn import FPN as JFPN
from handnet_tpu.nn.resnet import resnet34 as j_resnet34
from handnet_tpu.nn.resnet import resnet50_dilated as j_resnet50_dilated
from handnet_tpu.ops import anchors as janchors
from handnet_tpu.ops import crop_resize as jcrop
from handnet_tpu.ops import geometry as jgeo
from handnet_tpu_torch import config as pconfig
from handnet_tpu_torch.convert.from_flax import (a2j_state_dict_from_flax,
                                                 fcos_state_dict_from_flax)
from handnet_tpu_torch.models import a2j as pa2j
from handnet_tpu_torch.models import fcos as pfcos
from handnet_tpu_torch.nn.fpn import FPN
from handnet_tpu_torch.nn.resnet import resnet34, resnet50_dilated
from handnet_tpu_torch.ops import anchors as panchors
from handnet_tpu_torch.ops import crop_resize as pcrop
from handnet_tpu_torch.ops import geometry as pgeo
from torch_port_fixtures import assert_close, leaves_equal, nhwc, randomize_norms

REPO = Path(__file__).resolve().parent.parent
IMAGE_H, IMAGE_W, CROP = 64, 96, 64


def _close_to(got, want, err_msg=""):
    want = np.asarray(want)
    assert_close(got, want, rtol=1e-4, atol=1e-4 * max(1.0, float(np.abs(want).max())),
                 err_msg=err_msg)


def _prefixed(state_dict, prefix):
    return {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}


def _jcfg_fcos(**kw):
    return FCOSConfig(num_classes=3, ext=False, image_h=IMAGE_H, image_w=IMAGE_W,
                      max_detections=16, **kw)


def _pcfg_fcos(**kw):
    return pconfig.FCOSConfig(num_classes=3, ext=False, image_h=IMAGE_H,
                              image_w=IMAGE_W, max_detections=16, **kw)


@pytest.fixture(scope="module")
def fcos_vars():
    """JAX FCOS variables (init + random norms), numpy leaves."""
    system = jfcos.FCOSSystem(_jcfg_fcos())
    v = jax.jit(system.init)(jax.random.PRNGKey(0))
    return randomize_norms(jax.tree_util.tree_map(np.asarray, v), seed=1)


@pytest.fixture(scope="module")
def a2j_vars():
    system = ja2j.A2JSystem(A2JConfig(crop_h=CROP, crop_w=CROP))
    v = jax.jit(system.init)(jax.random.PRNGKey(1))
    return randomize_norms(jax.tree_util.tree_map(np.asarray, v), seed=2)


def _sub(variables, name):
    return {col: tree[name] for col, tree in variables.items() if name in tree}


# ---------------------------------------------------------------------------
# anchors, config, weights


@pytest.mark.parametrize("feat,stride,transposed", [
    ((11, 11), 16, False), ((11, 11), 16, True), ((3, 4), 16, False), ((4, 4), 8, True)])
def test_a2j_anchor_grid_bit_equal(feat, stride, transposed):
    want = janchors.a2j_anchor_grid(*feat, stride, transposed=transposed)
    got = panchors.a2j_anchor_grid(*feat, stride, transposed=transposed)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("hw", [(480, 640), (64, 96), (800, 1088), (61, 93)])
def test_fcos_anchor_pyramid_bit_equal(hw):
    want = janchors.fcos_anchor_pyramid(*hw, (8, 16, 32))
    got = panchors.fcos_anchor_pyramid(*hw, (8, 16, 32))
    for w, g in zip(want[:2], got[:2]):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert got[2] == want[2]


def test_fcos_weights_round_trip(fcos_vars):
    """flax -> port -> flax gives back every leaf exactly, and the port's
    FCOS loads the converted state dict strictly."""
    sd = fcos_state_dict_from_flax(fcos_vars)
    assert leaves_equal(convert_fcos({k: v.numpy() for k, v in sd.items()}), fcos_vars)
    pfcos.FCOSSystem(_pcfg_fcos()).load_state_dict(sd, strict=True)


def test_a2j_weights_round_trip(a2j_vars):
    sd = a2j_state_dict_from_flax(a2j_vars)
    assert leaves_equal(convert_a2j({k: v.numpy() for k, v in sd.items()}), a2j_vars)
    pa2j.A2JSystem(pconfig.A2JConfig(crop_h=CROP, crop_w=CROP)).load_state_dict(
        sd, strict=True)


# ---------------------------------------------------------------------------
# backbones, FPN, heads


def test_resnet34_frozen_matches_flax(fcos_vars):
    x = np.random.default_rng(3).normal(size=(2, IMAGE_H, IMAGE_W, 3)).astype(np.float32)
    want = j_resnet34(norm="frozen").apply(_sub(fcos_vars, "backbone"), jnp.asarray(x))
    net = resnet34()
    net.load_state_dict(_prefixed(fcos_state_dict_from_flax(fcos_vars), "backbone.body."))
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    for level in ("c1", "c2", "c3", "c4", "c5"):
        _close_to(nhwc(got[level]), want[level], err_msg=level)


def test_resnet50_dilated_matches_flax(a2j_vars):
    """Eval-mode BatchNorm, layer4 stride 1 / dilation 2, first dilated
    block at the previous dilation."""
    x = np.random.default_rng(4).normal(size=(2, CROP, CROP, 3)).astype(np.float32)
    want = j_resnet50_dilated(norm="batch").apply(_sub(a2j_vars, "backbone"),
                                                  jnp.asarray(x))
    net = resnet50_dilated()
    net.load_state_dict(_prefixed(a2j_state_dict_from_flax(a2j_vars), "Backbone.model."))
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got["c5"].shape[-2:] == got["c4"].shape[-2:]  # both stride 16
    for level in ("c4", "c5"):
        _close_to(nhwc(got[level]), want[level], err_msg=level)


def test_fpn_matches_flax(fcos_vars):
    """Odd coarse maps exercise the exact-size floor upsample."""
    rng = np.random.default_rng(5)
    feats = [rng.normal(size=s).astype(np.float32)
             for s in ((2, 9, 13, 128), (2, 5, 7, 256), (2, 3, 4, 512))]
    want = JFPN(out_channels=256).apply(_sub(fcos_vars, "fpn"),
                                        [jnp.asarray(f) for f in feats])
    net = FPN()
    net.load_state_dict(_prefixed(fcos_state_dict_from_flax(fcos_vars), "backbone.fpn."))
    with torch.no_grad():
        got = net([torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats])
    for i, (g, w) in enumerate(zip(got, want)):
        _close_to(nhwc(g), w, err_msg=f"level {i}")


@pytest.mark.parametrize("gn_fast_variance", [False, True])
def test_fcos_head_matches_flax(gn_fast_variance):
    """Narrow head (64 channels, still 32 groups). The JAX side runs both GN
    variants; the port always takes K2's exact statistics."""
    jcfg = _jcfg_fcos(fpn_channels=64, gn_fast_variance=gn_fast_variance)
    rng = np.random.default_rng(6)
    feats = [rng.normal(1.0, 2.0, size=(2, h, w, 64)).astype(np.float32)
             for h, w in ((8, 12), (4, 6), (2, 3))]
    head = jfcos.FCOSHead(cfg=jcfg)
    v = head.init(jax.random.PRNGKey(2), [jnp.asarray(f) for f in feats])
    v = randomize_norms(jax.tree_util.tree_map(np.asarray, v), seed=7)
    want = head.apply(v, [jnp.asarray(f) for f in feats])
    net = pfcos.FCOSHead(_pcfg_fcos(fpn_channels=64))
    net.load_state_dict(_prefixed(fcos_state_dict_from_flax({"params": {"head": v["params"]}}),
                                  "head."), strict=True)
    with torch.no_grad():
        got = net([torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats])
    assert sorted(got) == sorted(want)
    for key in want:
        _close_to(got[key], want[key], err_msg=key)


def test_a2j_matches_flax(a2j_vars):
    """Heads in the JAX (h, w, a) anchor order, and the decoded UVD."""
    cfg = A2JConfig(crop_h=CROP, crop_w=CROP)
    system = ja2j.A2JSystem(cfg)
    crops = np.random.default_rng(8).uniform(0.3, 1.0, size=(2, CROP, CROP, 1)
                                             ).astype(np.float32)
    want = system.module.apply(a2j_vars, jnp.asarray(crops))
    want_uvd = system.predict(a2j_vars, jnp.asarray(crops))
    net = pa2j.A2JSystem(pconfig.A2JConfig(crop_h=CROP, crop_w=CROP))
    net.load_state_dict(a2j_state_dict_from_flax(a2j_vars), strict=True)
    with torch.no_grad():
        got = net(torch.from_numpy(crops))
        got_uvd = net.predict(torch.from_numpy(crops))
    for key in ("cls", "reg", "depth"):
        assert tuple(got[key].shape) == want[key].shape
        _close_to(got[key], want[key], err_msg=key)
    _close_to(got_uvd, want_uvd, err_msg="uvd")


# ---------------------------------------------------------------------------
# preprocess, decode, handoff


def test_preprocess_native_branch():
    rng = np.random.default_rng(9)
    cfg_j, cfg_p = _jcfg_fcos(), _pcfg_fcos()
    for frames in (rng.uniform(size=(2, IMAGE_H, IMAGE_W, 3)).astype(np.float32),
                   rng.integers(0, 256, size=(2, IMAGE_H, IMAGE_W, 3), dtype=np.uint8),
                   rng.uniform(size=(2, IMAGE_H, IMAGE_W - 8, 3)).astype(np.float32)):
        want, want_scale = jfcos.preprocess(jnp.asarray(frames), cfg_j)
        got, got_scale = pfcos.preprocess(torch.from_numpy(frames), cfg_p)
        assert got_scale == want_scale
        assert_close(got, want, rtol=1e-6, atol=1e-6)


def _random_head(rng, n, num_classes=3):
    return {
        "cls_logits": rng.normal(size=(3, n, num_classes)).astype(np.float32),
        "hand_lr": rng.normal(size=(3, n, 2)).astype(np.float32),
        # boxes a few anchors wide: neighbours overlap, so NMS suppresses
        "bbox_regression": rng.uniform(0.5, 3.0, size=(3, n, 4)).astype(np.float32),
        "bbox_ctrness": rng.normal(size=(3, n, 1)).astype(np.float32),
    }


@pytest.mark.parametrize("score_thresh", [0.0, 0.55])
def test_decode_detections_exact(score_thresh):
    """Same head tensors on both sides: equal keep masks, and equal labels,
    sides and boxes under it."""
    cfg_j, cfg_p = (_jcfg_fcos(score_thresh=score_thresh),
                    _pcfg_fcos(score_thresh=score_thresh))
    anchors = janchors.fcos_anchor_pyramid(IMAGE_H, IMAGE_W)[0]
    head = _random_head(np.random.default_rng(10), anchors.shape[0])
    want = jfcos.decode_detections({k: jnp.asarray(v) for k, v in head.items()},
                                   jnp.asarray(anchors), cfg_j, scale_to_original=(1.0, 1.0))
    got = pfcos.decode_detections({k: torch.from_numpy(v) for k, v in head.items()},
                                  torch.from_numpy(anchors), cfg_p,
                                  scale_to_original=(1.0, 1.0))
    keep = np.asarray(want["valid"])
    assert np.array_equal(got["valid"].numpy(), keep)
    assert 0 < keep.sum() < keep.size  # some kept, some suppressed or invalid
    for key in ("labels", "sides", "boxes"):
        assert np.array_equal(got[key].numpy()[keep], np.asarray(want[key])[keep]), key
    assert_close(got["scores"], want["scores"], rtol=1e-6, atol=1e-7)


def test_pad_box_and_crop_exact():
    rng = np.random.default_rng(11)
    h, w = 60, 80
    x1 = rng.uniform(-10, w, size=16)
    y1 = rng.uniform(-10, h, size=16)
    boxes = np.stack([x1, y1, x1 + rng.uniform(0, 50, 16), y1 + rng.uniform(0, 40, 16)],
                     axis=-1).astype(np.float32)
    want = jax.vmap(lambda b: jcrop.pad_box(b, 0.4, h, w))(jnp.asarray(boxes))
    got = pcrop.pad_box(torch.from_numpy(boxes), 0.4, h, w)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), np.asarray(want))

    images = rng.normal(size=(16, h, w, 2)).astype(np.float32)
    crops_j = jax.vmap(lambda im, b: jcrop.crop_resize_nearest(im, b, 24, 24))(
        jnp.asarray(images), want)
    crops_p = pcrop.crop_resize_nearest(torch.from_numpy(images), got, 24, 24)
    assert np.array_equal(crops_p.numpy(), np.asarray(crops_j))


def test_geometry_matches():
    rng = np.random.default_rng(12)
    uvd = rng.uniform(0, 48, size=(3, 21, 3)).astype(np.float32)
    uvd[..., 2] = rng.uniform(0.3, 1.0, size=(3, 21))
    box = np.array([[4, 6, 40, 50], [0, 0, 47, 47], [10, 3, 30, 33]], np.float32)
    paras = np.tile([600.0, 610.0, 40.0, 30.0], (3, 1)).astype(np.float32)
    t = torch.from_numpy
    assert_close(pgeo.uvd2xyz(t(uvd), t(paras)), jgeo.uvd2xyz(uvd, paras), 1e-6, 1e-6)
    assert_close(pgeo.crop_uvd_to_image_uvd(t(uvd), t(box), 48, 48),
                 jgeo.crop_uvd_to_image_uvd(uvd, box, 48, 48), 1e-6, 1e-5)
    assert_close(pgeo.convert_joints(t(uvd), t(box), t(paras), 48, 48),
                 jgeo.convert_joints(uvd, box, paras, 48, 48), 1e-6, 1e-3)


# ---------------------------------------------------------------------------
# tree hygiene


def test_port_tree_hygiene():
    """The port never imports jax, each CUDA source names the JAX function
    it replaces (a Pallas kernel, or for K3q and K3g the XLA int8 conv),
    every header under csrc/ is included by a source, and the resize
    (``ops/resize.py``, two matmuls as in the JAX package) launches no
    kernel of the port's own."""
    pkg = REPO / "handnet_tpu_torch"
    jax_import = re.compile(r"^\s*(import jax|from jax)\b", re.M)
    offenders = [p.name for p in pkg.rglob("*.py") if jax_import.search(p.read_text())]
    assert offenders == []
    resize = (pkg / "ops" / "resize.py").read_text()
    assert "handnet_tpu/ops/resize.py" in resize and "torch.bmm" in resize
    assert "handnet_tpu_torch.kernels" not in resize
    sources = sorted((pkg / "csrc").glob("*.cu"))
    assert [p.name for p in sources] == ["a2j_decode.cu", "gn_apply.cu", "gn_backward_dx.cu",
                                         "gn_backward_sums.cu", "gn_stats.cu",
                                         "int8_conv.cu", "int8_quantize.cu"]
    replaces = {"a2j_decode.cu": ("_decode_kernel", "a2j_decode_pallas",
                                  "handnet_tpu/ops/pallas_a2j.py"),
                "gn_apply.cu": ("pallas_group_norm", "handnet_tpu/ops/pallas_gn.py:152-169"),
                # the backward replaces no Pallas kernel: it names the flax
                # GroupNorm whose gradient XLA derives
                "gn_backward_dx.cu": ("pallas_group_norm", "no VJP",
                                      "handnet_tpu/models/fcos.py:62-65"),
                "gn_backward_sums.cu": ("pallas_group_norm", "no VJP",
                                        "handnet_tpu/models/fcos.py:62-65"),
                "gn_stats.cu": ("_stats_kernel", "gn_group_stats",
                                "handnet_tpu/ops/pallas_gn.py"),
                "int8_conv.cu": ("QuantConv", "conv_general_dilated", "wgmma",
                                 "handnet_tpu/nn/quant.py:122-151"),
                "int8_quantize.cu": ("QuantConv", "quantize_symmetric",
                                     "handnet_tpu/nn/quant.py:122-151")}
    for src in sources:
        text = src.read_text()
        for name in replaces[src.name]:
            assert name in text, (src.name, name)
        assert "mma.sync" not in text, src.name   # the pre-Hopper K3 is gone
    headers = sorted(p.name for p in (pkg / "csrc").glob("*.cuh"))
    assert headers == ["chunk16.cuh", "gn_backward.cuh", "round_to_byte.cuh", "split_done.cuh",
                       "wgmma_s8.cuh"]
    included = "".join(src.read_text() for src in sources)
    for header in headers:
        assert f'#include "{header}"' in included, header
