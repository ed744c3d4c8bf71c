"""The port's Faster R-CNN (``handnet_tpu_torch/models/faster_rcnn.py``, the
box coders and NMS of ``ops/``, ``RCNNTrainer`` and the weight converters)
against the JAX package's, on the CPU, at 64x96 with 16 proposals.

Tolerances, each with what was measured on this CPU:
* the box coders, clipping, resizing, NMS and the top-k: masks, indices,
  clipped and resized boxes equal; the coders ``BOX_TOL`` relative
  (measured 7.3e-8: XLA turns the divisions by the weights into products);
* RoIAlign, one level and FPN-assigned, against JAX and a numpy oracle:
  ``ROI_TOL`` (measured 2.4e-7 against JAX, 0 against the oracle);
* the anchor table at 64x96 and at 800x1088: equal;
* the heads alone in eval mode: ``HEAD_TOL`` of scale (measured 9.7e-7);
* ``propose`` and ``roi_forward`` on JAX's own pyramid (frozen, batch and
  group norms): the same valid set, every output within ``HEAD_TOL`` of
  its scale (measured 2.0e-6), the proposals within ``PROP_PX`` px. The
  random RPN's deltas reach ``BBOX_XFORM_CLIP``, where ``exp`` makes a box
  side of 60 times its anchor's, so the RPN convs' rounding moves such a
  side by up to 7.9e-4 px (measured), 1e-5 of the frame;
* the whole forward: the pyramid (measured 3.5e-6 of scale) and every
  output within ``FWD_TOL`` of its scale (7.0e-5: the proposals move, and
  RoIAlign reads other taps) with the same valid set; the proposals within
  ``FWD_PROP_PX`` (1.1e-3 px measured, 6.3e-3 in train mode; 1e-4 of the
  96-px frame);
* the train-mode forward (batch norm): every output but ``contact`` (the
  dropout's draws cannot be equal) within ``TRAIN_TOL`` of its scale, the
  batch statistics within ``STATS_TOL``. Batch statistics of a random
  ResNet-34 amplify rounding: the class scores move by 4.8e-4 of their
  scale (measured);
* ``decode_rcnn_detections`` on one set of outputs: valid, labels, sides
  and contacts equal, boxes within ``BOX_PX`` (measured 7.6e-6 px);
* the losses: each term within ``LOSS_TOL`` relative; the RPN's fg/bg
  masks equal at the 800x1088 table (read from the sign of JAX's gradient
  of the objectness loss);
* the gradient of the summed losses (frozen norms, dropout off, one set of
  proposals), each forward from the frames, JAX's in float64: the losses
  within ``FWD_TOL`` relative; the port's gradient in float64, every
  parameter within ``GRAD_TOL`` of its largest value; the port's in
  float32, within ``GRAD_TOL`` outside the backbone and within
  ``F32_BACKBONE_GRAD_TOL`` in it, whose float32 gradient is not smooth at
  64x96 (test_float32_gradients_match_jax); one ``RCNNTrainer`` SGD step
  against optax's update of the same parameters by the port's gradient:
  each parameter's change within ``STEP_TOL``, plus the float32 rounding;
* a bf16 loss: each term within ``BF16_TOL`` relative;
* the weights: round trips exact.

The JAX CLIs and the port's (``train_fcos``/``eval_fcos --net rcnn``) are
held in tests/test_torch_port_rcnn_apps.py.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handnet_tpu import config as jconfig
from handnet_tpu.convert.torch_weights import convert_faster_rcnn
from handnet_tpu.models import faster_rcnn as J
from handnet_tpu.ops import boxes as jboxes
from handnet_tpu.ops import nms as jnms
from handnet_tpu.train import trainer as jtrainer
from handnet_tpu_torch import config as pconfig
from handnet_tpu_torch.convert.from_flax import (faster_rcnn_state_dict_from_flax,
                                                 faster_rcnn_variables_from_state_dict)
from handnet_tpu_torch.convert.torch_weights import faster_rcnn_state_dict
from handnet_tpu_torch.models import faster_rcnn as P
from handnet_tpu_torch.ops import boxes as pboxes
from handnet_tpu_torch.ops import nms as pnms
from handnet_tpu_torch.train.trainer import RCNNTrainer
from torch_port_fixtures import leaves_equal

H, W, K = 64, 96, 16
BOX_TOL, ROI_TOL, HEAD_TOL = 1e-6, 1e-5, 1e-4
PROP_PX, FWD_TOL, FWD_PROP_PX, STATS_TOL, BOX_PX = 1e-3, 1e-4, 1e-2, 1e-5, 1e-4
LOSS_TOL, GRAD_TOL, STEP_TOL, BF16_TOL, TRAIN_TOL = 1e-5, 1e-4, 1e-4, 3e-2, 1e-3
F32_BACKBONE_GRAD_TOL = 5e-2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _nchw(a) -> torch.Tensor:
    return _t(a).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


# ---------------------------------------------------------------------------
# box ops, NMS, top-k


def _boxes(rng, n, lo=0.0, hi=90.0):
    xy = rng.uniform(lo, hi, size=(n, 2))
    wh = rng.uniform(1.0, 40.0, size=(n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def test_box_coders_clip_resize_match_jax():
    rng = np.random.default_rng(0)
    gt, props = _boxes(rng, 64).reshape(4, 16, 4), _boxes(rng, 64).reshape(4, 16, 4)
    codes = rng.normal(0, 2, size=(4, 16, 4)).astype(np.float32)
    codes[0, 0, 2:] = 9.0    # past BBOX_XFORM_CLIP
    assert pboxes.BBOX_XFORM_CLIP == jboxes.BBOX_XFORM_CLIP
    for weights in ((1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)):
        enc = jax.jit(functools.partial(jboxes.delta_encode, weights=weights))(gt, props)
        dec = jax.jit(functools.partial(jboxes.delta_decode, weights=weights))(codes, props)
        assert _rel(pboxes.delta_encode(_t(gt), _t(props), weights), enc) <= BOX_TOL
        assert _rel(pboxes.delta_decode(_t(codes), _t(props), weights), dec) <= BOX_TOL
    wide = rng.uniform(-30, 130, size=(3, 8, 4)).astype(np.float32)
    np.testing.assert_array_equal(pboxes.clip_boxes(_t(wide), H, W).numpy(),
                                  jboxes.clip_boxes(wide, H, W))
    np.testing.assert_array_equal(pboxes.resize_boxes(_t(wide), (480, 640), (H, W)).numpy(),
                                  jboxes.resize_boxes(wide, (480, 640), (H, W)))


def test_nms_fixed_and_topk_match_jax():
    """The single-class NMS over a [B, K] batch equals JAX's vmapped one,
    overlapping clusters and invalid entries included; the top-k keeps
    ties in index order, as ``jax.lax.top_k``."""
    rng = np.random.default_rng(1)
    centres = rng.uniform(10, 80, size=(3, 6, 2))
    boxes = np.concatenate([centres - 8, centres + 8], -1).repeat(6, 1)
    boxes += rng.normal(0, 3, size=boxes.shape)
    boxes = boxes.astype(np.float32)
    valid = rng.uniform(size=(3, 36)) > 0.2
    for thresh in (0.3, 0.5, 0.7):
        want = jax.vmap(lambda b, v: jnms.nms_fixed(b, None, v, thresh))(boxes, valid)
        got = pnms.nms_fixed(_t(boxes), None, _t(valid), thresh)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert 0 < got.sum() < valid.sum()
    scores = rng.integers(0, 5, size=(3, 40)).astype(np.float32)   # many ties
    scores[0, :3] = -np.inf
    vals, idx = jax.lax.top_k(scores, 12)
    pv, pi = pnms.topk_candidates(_t(scores), 12)
    np.testing.assert_array_equal(pv.numpy(), np.asarray(vals))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(idx))


# ---------------------------------------------------------------------------
# RoIAlign


def numpy_roi_align_oracle(feat, roi, out_size, scale, sampling=2):
    """A copy of tests/test_faster_rcnn.py's oracle: one roi, one [H, W, C]
    map, the JAX package's bilinear convention tap by tap."""
    h, w, c = feat.shape
    x1, y1, x2, y2 = [v * scale for v in roi]
    bw = (x2 - x1) / out_size
    bh = (y2 - y1) / out_size
    out = np.zeros((out_size, out_size, c), np.float32)

    def bilinear(yy, xx):
        y0 = min(max(int(np.floor(yy)), 0), h - 1)
        x0 = min(max(int(np.floor(xx)), 0), w - 1)
        y1i = min(y0 + 1, h - 1)
        x1i = min(x0 + 1, w - 1)
        wy = min(max(yy - y0, 0), 1)
        wx = min(max(xx - x0, 0), 1)
        return ((1 - wy) * (1 - wx) * feat[y0, x0] + (1 - wy) * wx * feat[y0, x1i]
                + wy * (1 - wx) * feat[y1i, x0] + wy * wx * feat[y1i, x1i])

    for i in range(out_size):
        for j in range(out_size):
            acc = 0.0
            for si in range(sampling):
                for sj in range(sampling):
                    yy = y1 + (i + (si + 0.5) / sampling) * bh - 0.5
                    xx = x1 + (j + (sj + 0.5) / sampling) * bw - 0.5
                    acc = acc + bilinear(yy, xx)
            out[i, j] = acc / (sampling * sampling)
    return out


# rois past the frame's edge, one narrower and lower than a pixel, and rois
# whose sqrt(wh) put them on each of P2..P5 (56, 112, 224, 448 px and up)
EDGE_ROIS = np.array([[-12.0, -8.0, 30.0, 20.0], [70.0, 50.0, 110.0, 80.0],
                      [40.0, 30.0, 40.4, 30.7], [5.0, 6.0, 40.0, 50.0],
                      [0.0, 0.0, 96.0, 64.0], [-100.0, -90.0, 150.0, 140.0],
                      [-300.0, -250.0, 300.0, 260.0], [-20.5, -9.75, 119.5, 90.25]], np.float32)


def test_roi_align_matches_jax_and_oracle():
    rng = np.random.default_rng(2)
    feat = rng.normal(size=(2, 16, 24, 8)).astype(np.float32)
    rois = np.stack([EDGE_ROIS, EDGE_ROIS[::-1] + 3.0])
    got = P.roi_align(_nchw(feat), _t(rois), 7, 0.25).numpy()
    want = jax.vmap(lambda f, r: J.roi_align(f, r, 7, 0.25))(feat, rois)
    assert got.shape == (2, 8, 7, 7, 8)
    assert np.abs(got - np.asarray(want)).max() <= ROI_TOL
    for b in range(2):
        for r in range(8):
            oracle = numpy_roi_align_oracle(feat[b], rois[b, r], 7, 0.25)
            assert np.abs(got[b, r] - oracle).max() <= ROI_TOL, (b, r)


def test_multiscale_roi_align_matches_jax_on_every_level():
    rng = np.random.default_rng(3)
    pyramid = [rng.normal(size=(2, H // s, W // s, 8)).astype(np.float32)
               for s in (4, 8, 16, 32)]
    rois = np.stack([EDGE_ROIS, EDGE_ROIS + 1.5])
    lvl = P.roi_levels(_t(rois), 4, 2).numpy()
    assert set(lvl.reshape(-1)) == {0, 1, 2, 3}
    got = P.multiscale_roi_align([_nchw(p) for p in pyramid], _t(rois), 7, (4, 8, 16, 32))
    want = jax.vmap(lambda *a: J.multiscale_roi_align(list(a[:-1]), a[-1], 7, (4, 8, 16, 32)))(
        *pyramid, rois)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= ROI_TOL
    # and each roi equals the one-level pooling at its own level
    for b, r in ((0, 0), (0, 4), (1, 5), (1, 6)):
        s = (4, 8, 16, 32)[lvl[b, r]]
        oracle = numpy_roi_align_oracle(pyramid[lvl[b, r]][b], rois[b, r], 7, 1.0 / s)
        assert np.abs(got[b, r].numpy() - oracle).max() <= ROI_TOL


@pytest.mark.parametrize("hw", [(64, 96), (800, 1088)])
def test_rpn_anchor_grid_equals_jax(hw):
    m = P.FasterRCNNFPN
    got = P.rpn_anchor_grid(*hw, m.strides, m.anchor_sizes, m.aspect_ratios)
    want = J.rpn_anchor_grid(*hw, (4, 8, 16, 32, 64), (32, 64, 128, 256, 512), (0.5, 1.0, 2.0))
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert got.shape[0] == {(64, 96): 1536, (800, 1088): 217413}[hw]


# ---------------------------------------------------------------------------
# the modules


def _port_model(norm: str, seed: int = 0) -> P.FasterRCNNFPN:
    """The port's init at 64x96 with every bias and norm parameter (and the
    batch norms' running statistics) drawn at random, so that each
    conversion is exercised."""
    model = P.FasterRCNNFPN(3, H, W, K, backbone_norm=norm)
    model.init_weights_(torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p in model.parameters():
            if p.ndim == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
        for name, b in model.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(0.1 * torch.randn(b.shape, generator=gen))
            elif name.endswith("running_var"):
                b.copy_(1.0 + 0.2 * torch.rand(b.shape, generator=gen))
    return model.to(memory_format=torch.channels_last).eval()


@functools.lru_cache(maxsize=None)
def _built(norm: str):
    """(port model, flax variables, the JAX module, jitted JAX methods)."""
    pm = _port_model(norm)
    variables = faster_rcnn_variables_from_state_dict(pm.state_dict())
    jm = J.FasterRCNNFPN(num_classes=3, image_h=H, image_w=W, num_proposals=K,
                         backbone_norm=norm)
    fns = {
        "features": jax.jit(lambda v, x: jm.apply(v, x, method=jm.features)),
        "propose": jax.jit(lambda v, p: jm.apply(v, p, method=jm.propose)),
        "roi": jax.jit(lambda v, p, r: jm.apply(v, p, r, method=jm.roi_forward)),
    }
    return pm, variables, jm, fns


def _images(seed=0, b=2):
    return np.random.default_rng(seed).normal(size=(b, H, W, 3)).astype(np.float32)


def _jax_forward(norm: str, x):
    """JAX's ``__call__`` in eval mode, as its three methods."""
    _, v, _, fns = _built(norm)
    pyramid = fns["features"](v, x)
    props, scores, valid, obj, reg = fns["propose"](v, pyramid)
    head = fns["roi"](v, pyramid, props)
    return pyramid, {"proposals": props, "rpn_scores": scores, "proposal_valid": valid,
                     "rpn_objectness": obj, "rpn_deltas": reg, **head}


def _assert_scores(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    assert np.abs(got[fin] - want[fin]).max() <= tol * np.abs(want[fin]).max()


def test_heads_match_jax_in_eval_mode():
    """RPNHead, TwoMLPHead and FastRCNNPredictor alone, with the full-width
    model's converted weights (fc6 takes 7 x 7 x 256 rois)."""
    pm, v, _, _ = _built("frozen")
    rng = np.random.default_rng(4)
    params = v["params"]
    feats = [rng.normal(size=(2, h, w, 256)).astype(np.float32) for h, w in ((8, 12), (4, 6))]
    j_obj, j_reg = J.RPNHead(256, 3).apply({"params": params["rpn_head"]}, feats)
    with torch.no_grad():
        p_obj, p_reg = pm.rpn["head"]([_nchw(f) for f in feats])
    assert _rel(p_obj, j_obj) <= HEAD_TOL and _rel(p_reg, j_reg) <= HEAD_TOL
    pooled = rng.normal(size=(5, 7, 7, 256)).astype(np.float32)
    j_x = J.TwoMLPHead(1024).apply({"params": params["box_head"]}, pooled)
    with torch.no_grad():
        p_x = pm.roi_heads["box_head"](_t(pooled))
    assert _rel(p_x, j_x) <= HEAD_TOL
    x = rng.normal(size=(5, 1024)).astype(np.float32)
    j_out = J.FastRCNNPredictor(3).apply({"params": params["predictor"]}, x)
    with torch.no_grad():
        p_out = pm.roi_heads["box_predictor"](_t(x))
    assert j_out.keys() == p_out.keys()
    for k in j_out:
        assert _rel(p_out[k], j_out[k]) <= HEAD_TOL, k


@pytest.mark.parametrize("norm", ["frozen", "batch", "group"])
def test_forward_matches_jax(norm):
    """The eval-mode forward, whole and in its parts: ``propose`` and
    ``roi_forward`` on JAX's pyramid and proposals, the whole forward on
    the frames, and ``decode_rcnn_detections`` on JAX's outputs."""
    pm, v, _, fns = _built(norm)
    x = _images()
    pyramid, want = _jax_forward(norm, x)
    shared = [_nchw(p) for p in pyramid]
    with torch.no_grad():
        props, scores, valid, obj, reg = pm.propose(shared)
        head = pm.roi_forward(shared, _t(want["proposals"]))
        got = pm(_t(x))
        got_pyramid = pm.features(_t(x))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want["proposal_valid"]))
    assert valid.sum() > 0
    assert np.abs(props.numpy() - np.asarray(want["proposals"])).max() <= PROP_PX
    _assert_scores(scores, want["rpn_scores"], HEAD_TOL)
    assert _rel(obj, want["rpn_objectness"]) <= HEAD_TOL
    assert _rel(reg, want["rpn_deltas"]) <= HEAD_TOL
    for k in ("scores", "deltas", "contact", "dxdy", "side"):
        assert head[k].shape == want[k].shape and _rel(head[k], want[k]) <= HEAD_TOL, k

    assert got.keys() == want.keys()
    for level, (a, b) in enumerate(zip(got_pyramid, pyramid)):
        assert _rel(a.permute(0, 2, 3, 1), b) <= FWD_TOL, level
    np.testing.assert_array_equal(got["proposal_valid"].numpy(),
                                  np.asarray(want["proposal_valid"]))
    assert np.abs(got["proposals"].numpy() - np.asarray(want["proposals"])).max() <= FWD_PROP_PX
    _assert_scores(got["rpn_scores"], want["rpn_scores"], FWD_TOL)
    for k in ("rpn_objectness", "rpn_deltas", "scores", "deltas", "contact", "dxdy", "side"):
        assert _rel(got[k], want[k]) <= FWD_TOL, k

    det_want = jax.jit(lambda o: J.decode_rcnn_detections(o, 3, image_hw=(H, W)))(want)
    det = P.decode_rcnn_detections({k: _t(a) for k, a in want.items()}, 3, image_hw=(H, W))
    assert det.keys() == det_want.keys()
    ok = np.asarray(det_want["valid"])
    np.testing.assert_array_equal(det["valid"].numpy(), ok)
    assert ok.sum() > 0
    for k in ("labels", "sides", "contacts"):
        np.testing.assert_array_equal(det[k].numpy()[ok], np.asarray(det_want[k])[ok], err_msg=k)
    assert np.abs(det["boxes"].numpy()[ok] - np.asarray(det_want["boxes"])[ok]).max() <= BOX_PX
    assert _rel(det["scores"], det_want["scores"]) <= BOX_TOL
    assert _rel(det["dxdymags"].numpy()[ok], np.asarray(det_want["dxdymags"])[ok]) <= BOX_TOL


def test_train_mode_forward_and_batch_statistics_match_jax():
    """Batch norm in train mode: every output but the dropout's ``contact``,
    and the running statistics the forward leaves (flax's momentum 0.9 and
    biased variance)."""
    pm0, v, jm, _ = _built("batch")
    pm = copy.deepcopy(pm0).train()
    x = _images(seed=5)
    want, updates = jax.jit(lambda v, x: jm.apply(
        v, x, train=True, mutable=["batch_stats"],
        rngs={"dropout": jax.random.PRNGKey(0)}))(v, x)
    got = pm(_t(x))
    np.testing.assert_array_equal(got["proposal_valid"].numpy(),
                                  np.asarray(want["proposal_valid"]))
    assert np.abs(got["proposals"].detach().numpy()
                  - np.asarray(want["proposals"])).max() <= FWD_PROP_PX
    for k in ("rpn_objectness", "rpn_deltas", "scores", "deltas", "dxdy", "side"):
        assert _rel(got[k].detach(), want[k]) <= TRAIN_TOL, k
    stats = faster_rcnn_variables_from_state_dict(pm.state_dict())["batch_stats"]
    for path, a in jax.tree_util.tree_leaves_with_path(updates["batch_stats"]):
        node = stats
        for p in path:
            node = node[p.key]
        assert _rel(node, a) <= STATS_TOL, jax.tree_util.keystr(path)


# ---------------------------------------------------------------------------
# the losses


def _outputs(rng, b, r, c=3, n_anchors=1536):
    return {
        "scores": rng.normal(size=(b, r, c)).astype(np.float32),
        "deltas": rng.normal(0, 0.5, size=(b, r, 4 * c)).astype(np.float32),
        "contact": rng.normal(size=(b, r, 5 * c)).astype(np.float32),
        "dxdy": rng.normal(size=(b, r, 3 * c)).astype(np.float32),
        "side": rng.normal(size=(b, r, c)).astype(np.float32),
        "rpn_objectness": rng.normal(size=(b, n_anchors)).astype(np.float32),
        "rpn_deltas": rng.normal(0, 0.5, size=(b, n_anchors, 4)).astype(np.float32),
    }


def _targets(gt, labels, valid, rng):
    b, m = labels.shape
    info = np.concatenate([rng.integers(-1, 5, size=(b, m, 1)), rng.integers(0, 2, size=(b, m, 1)),
                           rng.normal(size=(b, m, 3))], -1).astype(np.float32)
    return {"boxes": gt.astype(np.float32), "labels": labels.astype(np.int32),
            "valid": valid, "box_info": info}


def _losses(outputs, targets, anchors):
    want = jax.jit(lambda o, t, a: {**J.rcnn_loss(o, t, 3), **J.rpn_loss(o, a, t)})(
        outputs, targets, anchors)
    po, pt = {k: _t(a) for k, a in outputs.items()}, {k: _t(a) for k, a in targets.items()}
    got = {**P.rcnn_loss(po, pt, 3), **P.rpn_loss(po, _t(anchors), pt)}
    assert got.keys() == want.keys()
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= LOSS_TOL * max(abs(float(want[k])), 1e-6), (
            k, float(got[k]), float(want[k]))
    return got, want


def test_losses_match_jax_with_ties():
    """Proposals on the GTs (duplicated GTs: the first index wins), near
    them and away; a padded GT; proposals that are degenerate boxes."""
    rng = np.random.default_rng(6)
    gt = np.array([[[10, 10, 40, 40], [50, 20, 90, 60], [50, 20, 90, 60], [0, 0, 0, 0]],
                   [[5, 5, 30, 45], [60, 10, 95, 50], [20, 30, 50, 62], [1, 1, 2, 2]]], np.float32)
    valid = np.array([[True, True, True, False], [True, True, True, False]])
    labels = np.array([[2, 1, 2, 0], [1, 2, 2, 0]])
    props = np.concatenate([gt[:, :3], gt[:, :3] + rng.normal(0, 3, size=(2, 3, 4)),
                            _boxes(rng, 20).reshape(2, 10, 4)], 1).astype(np.float32)
    props[:, -1] = [30.0, 30.0, 30.0, 31.0]        # zero width
    out = _outputs(rng, 2, props.shape[1])
    out["proposals"] = props
    anchors = P.rpn_anchor_grid(H, W, (4, 8, 16, 32, 64), (32, 64, 128, 256, 512),
                                (0.5, 1.0, 2.0))
    got, want = _losses(out, _targets(gt, labels, valid, rng), anchors)
    assert float(want["loss_box_reg"]) > 0 and float(want["loss_rpn_box_reg"]) > 0


def _rpn_masks_from_jax(anchors, targets):
    """JAX's fg/bg masks of ``rpn_loss``: at logits 0.5 the objectness
    loss's gradient is ``w (sigmoid(0.5) - fg) / n``, negative on
    foreground, positive on background and zero on ignored anchors (at 0
    the ``maximum`` in the BCE has no one-sided derivative)."""
    b, n = targets["boxes"].shape[0], anchors.shape[0]

    def obj_loss(obj):
        out = {"rpn_objectness": obj, "rpn_deltas": jnp.zeros((b, n, 4))}
        return J.rpn_loss(out, anchors, targets)["loss_objectness"]

    g = np.asarray(jax.jit(jax.grad(obj_loss))(jnp.full((b, n), 0.5)))
    return g < 0, g > 0


def test_rpn_masks_equal_jax_at_full_size():
    """The 800x1088 table (217,413 anchors) against GTs that are anchors
    (IoU 1, several anchors tying a GT's best), a duplicated GT, a GT
    between anchors (low-quality ties) and a padded GT."""
    anchors = P.rpn_anchor_grid(800, 1088, (4, 8, 16, 32, 64), (32, 64, 128, 256, 512),
                                (0.5, 1.0, 2.0))
    gt = np.stack([anchors[[5000, 5000, 90000, 200000]],
                   np.array([[100, 100, 164, 164], [101, 300, 300, 520],
                             [500, 40, 811, 300], [0, 0, 0, 0]], np.float32)])
    rng = np.random.default_rng(7)
    targets = _targets(gt, np.array([[2, 2, 1, 2], [1, 2, 1, 0]]),
                       np.array([[True, True, True, True], [True, True, True, False]]), rng)
    fg_j, bg_j = _rpn_masks_from_jax(anchors, targets)
    fg, bg, _ = P.rpn_assign(_t(anchors), _t(targets["boxes"]), _t(targets["valid"]))
    np.testing.assert_array_equal(fg.numpy(), fg_j)
    np.testing.assert_array_equal(bg.numpy(), bg_j)
    assert fg.sum() >= 8 and bg.sum() > 1000


def test_sampler_weights_above_the_caps():
    """More than 128 foreground and more than 512 - 128 background
    proposals per image (rcnn_loss), more than 128/256 anchors (rpn_loss):
    the expectation-balanced weights below 1 and ``n_sample``, analytically,
    and every term against JAX at those counts."""
    rng = np.random.default_rng(8)
    gt = np.array([[[10, 10, 40, 40], [50, 20, 90, 60]]] * 2, np.float32)
    valid, labels = np.ones((2, 2), bool), np.array([[2, 1], [1, 2]])
    n_fg, n_bg = (200, 150), (400, 500)     # per image
    props = []
    for i in range(2):
        near = gt[i][rng.integers(0, 2, n_fg[i])] + rng.uniform(-1, 1, size=(n_fg[i], 4))
        far = np.array([0.0, 0.0, 4.0, 4.0]) + rng.uniform(0, 2, size=(n_bg[i], 4))
        props.append(np.concatenate([near, far, far[:700 - n_fg[i] - n_bg[i]]])[:700])
    props = np.stack(props).astype(np.float32)
    iou = pboxes.box_iou(_t(props), _t(gt)).amax(-1)
    fg, bg = iou >= 0.5, iou < 0.5
    assert fg.sum(1).tolist() == [200, 150] and bg.sum(1).tolist() == [500, 550]
    w, n_sample = P._sampler_weights(fg, bg, 128, 512)
    for i in range(2):
        n_bg_s = min(int(bg[i].sum()), 512 - 128)
        assert torch.allclose(w[i][fg[i]], torch.tensor(128 / int(fg[i].sum())), rtol=0, atol=0)
        assert torch.allclose(w[i][bg[i]], torch.tensor(n_bg_s / int(bg[i].sum())), rtol=0, atol=0)
    assert int(n_sample) == 2 * 512
    out = _outputs(rng, 2, 700, n_anchors=600)
    out["proposals"] = props
    # anchors: 300 on the GTs (foreground), 300 far away (background)
    anchors = np.concatenate([gt[0][rng.integers(0, 2, 300)] + rng.uniform(-0.5, 0.5, (300, 4)),
                              np.array([0.0, 0.0, 3.0, 3.0]) + rng.uniform(0, 1, (300, 4))]
                             ).astype(np.float32)
    fg_a, bg_a, _ = P.rpn_assign(_t(anchors), _t(gt), _t(valid))
    assert fg_a.sum(1).tolist() == [300, 300] and bg_a.sum(1).tolist() == [300, 300]
    wa, na = P._sampler_weights(fg_a, bg_a, 128, 256)
    assert set(wa[fg_a].tolist()) == {np.float32(128 / 300)}
    assert set(wa[bg_a].tolist()) == {np.float32(128 / 300)} and int(na) == 2 * 256
    _losses(out, _targets(gt, labels, valid, rng), anchors)


# ---------------------------------------------------------------------------
# the gradient and the trainer


def _pin_proposals(model: P.FasterRCNNFPN, props, valid) -> None:
    """Make ``model.propose`` return ``props``/``valid`` as its proposals
    (its scores and raw RPN outputs its own). The proposals carry no
    gradient, but RoIAlign's taps jump to other pixels where a coordinate
    crosses an integer, so gradients are held on one set of boxes."""
    real = model.propose

    def pinned(pyramid, nms_thresh=0.7):
        _, scores, _, obj, reg = real(pyramid, nms_thresh)
        return _t(props), scores, _t(valid), obj, reg

    model.propose = pinned


def _port_losses(model: P.FasterRCNNFPN, x, targets, props, valid, dtype) -> dict:
    """The port's ``rcnn_loss + rpn_loss`` terms of a copy of ``model`` in
    ``dtype`` (train mode, its contact dropout in eval mode, its proposals
    pinned), after their sum's backward; returns ``(copy, terms)``."""
    pm = copy.deepcopy(model).to(dtype).train()
    pm.roi_heads["box_predictor"].hand_contact_state_layer[2].eval()
    _pin_proposals(pm, props, valid)
    tt = {k: _t(a) for k, a in targets.items()}
    o = pm(_t(x.astype(np.float64 if dtype == torch.float64 else np.float32)))
    losses = {**P.rcnn_loss(o, tt, 3), **P.rpn_loss(o, pm.anchors, tt)}
    sum(losses.values()).backward()
    return pm, losses


@pytest.fixture(scope="module")
def frozen_grads():
    """JAX's value and gradient of ``rcnn_loss + rpn_loss`` over the eval
    forward (frozen norms: train mode differs only by the dropout) in
    float64, with GTs placed on two of the port's proposals so that rois are
    foreground, and the roi heads run on those proposals (``features``,
    ``propose`` and ``roi_forward``, as ``__call__`` runs them); and the
    port's in float64 and in float32, its contact dropout in eval mode and
    its proposals pinned to the same."""
    pm0, v, _, _ = _built("frozen")
    x = _images(seed=9)
    with torch.no_grad():
        out = pm0.eval()(_t(x))
    props, valid = out["proposals"].numpy(), out["proposal_valid"].numpy()
    gt = np.stack([props[:, 0], props[:, 5] + 1.0, np.zeros_like(props[:, 0])], 1)
    rng = np.random.default_rng(9)
    targets = _targets(gt, np.array([[2, 1, 0], [1, 2, 0]]),
                       np.array([[True, True, False]] * 2), rng)
    with jax.enable_x64(True):
        jm = J.FasterRCNNFPN(num_classes=3, image_h=H, image_w=W, num_proposals=K,
                             backbone_norm="frozen", dtype=jnp.float64)
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), v)
        anchors = jnp.asarray(J.rpn_anchor_grid(H, W, jm.strides, jm.anchor_sizes,
                                                jm.aspect_ratios).astype(np.float64))

        def loss_fn(params):
            vv = {**v64, "params": params}
            pyramid = jm.apply(vv, x.astype(np.float64), method=jm.features)
            _, scores, _, obj, reg = jm.apply(vv, pyramid, method=jm.propose)
            o = {"proposals": props, "rpn_scores": scores, "proposal_valid": valid,
                 "rpn_objectness": obj, "rpn_deltas": reg,
                 **jm.apply(vv, pyramid, props, method=jm.roi_forward)}
            losses = {**J.rcnn_loss(o, targets, 3), **J.rpn_loss(o, anchors, targets)}
            return sum(losses.values()), losses

        (_, jl), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(v64["params"])
        jl = {k: float(a) for k, a in jl.items()}
        grads = jax.tree_util.tree_map(np.asarray, grads)
    pm, losses = _port_losses(pm0, x, targets, props, valid, torch.float32)
    pm64, losses64 = _port_losses(pm0, x, targets, props, valid, torch.float64)
    return {"x": x, "targets": targets, "jax_losses": jl, "grads": grads, "port": pm,
            "port_losses": losses, "port64": pm64, "port64_losses": losses64,
            "proposals": (props, valid)}


def _port_grads(model) -> dict:
    return faster_rcnn_variables_from_state_dict(
        {n: p.grad for n, p in model.named_parameters()})["params"]


def _leaf(tree, path):
    for p in path:
        tree = tree[p.key]
    return tree


def _assert_grads(frozen_grads, port: str, backbone_tol: float) -> None:
    jl, pl = frozen_grads["jax_losses"], frozen_grads[f"{port}_losses"]
    assert jl["loss_box_reg"] > 0 and jl["loss_contact"] > 0
    for k in jl:
        assert abs(pl[k].item() - jl[k]) <= FWD_TOL * max(abs(jl[k]), 1e-6), k
    pm = frozen_grads[port]
    got = _port_grads(pm)
    leaves = jax.tree_util.tree_leaves_with_path(frozen_grads["grads"])
    assert len(leaves) == len(list(pm.parameters()))
    for path, want in leaves:
        err = _rel(_leaf(got, path), want)
        tol = backbone_tol if path[0].key == "backbone" else GRAD_TOL
        assert err <= tol, (jax.tree_util.keystr(path), err, tol)


def test_gradients_match_jax(frozen_grads):
    """Both packages in float64: every parameter's gradient within
    ``GRAD_TOL`` of its largest value (measured 3e-7), the backbone's too."""
    _assert_grads(frozen_grads, "port64", GRAD_TOL)


def test_float32_gradients_match_jax(frozen_grads):
    """The port in float32 against JAX's float64 gradient: every parameter
    outside the backbone (the FPN, the RPN and the RoI heads) within
    ``GRAD_TOL`` of its largest value (measured 1.7e-6); each backbone
    parameter within ``F32_BACKBONE_GRAD_TOL`` (measured 2.9e-2 at
    ``layer4_1``, most leaves above 1e-4). With foreground rois the
    backbone's gradient is not smooth at 64x96: ReLUs near 0 on the 2x3
    ``layer4`` maps turn with float32 rounding, which float64 removes
    (test_gradients_match_jax)."""
    _assert_grads(frozen_grads, "port", F32_BACKBONE_GRAD_TOL)


def test_trainer_step_applies_jax_optimizer_update(frozen_grads):
    """One ``RCNNTrainer`` step (f32, frozen norms, SGD with its decay and
    momentum at the schedule's first rate; the contact dropout's rate set to
    0 and the proposals pinned as in ``frozen_grads``, so its loss and
    gradient are the fixture's float32 port's) against the JAX trainer's
    optimizer (``RCNNTrainer.tx``) updating the same parameters by that
    gradient: each parameter within ``STEP_TOL`` of its change, plus the
    float32 rounding of the sum. This holds the optimizer's update given
    one gradient; JAX's ``train_step`` does not run (its dropout draws
    from JAX's PRNG), and the gradient itself is held by the two tests
    above."""
    pm0, v, _, _ = _built("frozen")
    cfg = dict(num_classes=3, image_h=H, image_w=W)
    tcfg = dict(optimizer="sgd", lr=0.02, bf16=False, warmup_epochs=0)
    trainer = RCNNTrainer(pconfig.FCOSConfig(**cfg), pconfig.TrainConfig(**tcfg),
                          steps_per_epoch=4, backbone_norm="frozen", num_proposals=K,
                          device="cpu")
    state = trainer.init_state(0)
    state.model.load_state_dict(pm0.state_dict())
    state.model.roi_heads["box_predictor"].hand_contact_state_layer[2].rate = 0.0
    _pin_proposals(state.model, *frozen_grads["proposals"])
    batch = {"image": _t(frozen_grads["x"]),
             "targets": {k: _t(a) for k, a in frozen_grads["targets"].items()}}
    state, metrics = trainer.train_step(state, batch)
    assert state.step == 1 and np.isfinite(float(metrics["total_loss"]))
    assert abs(float(metrics["total_loss"]) - sum(frozen_grads["port_losses"].values()).item()) \
        <= 1e-6 * float(metrics["total_loss"])
    jt = jtrainer.RCNNTrainer(jconfig.FCOSConfig(**cfg), jconfig.TrainConfig(**tcfg),
                              steps_per_epoch=4, backbone_norm="frozen", num_proposals=K)
    params = v["params"]
    grads = _port_grads(frozen_grads["port"])
    updates, _ = jax.jit(jt.tx.update)(grads, jt.tx.init(params), params)
    want = jax.tree_util.tree_map(lambda p, u: np.asarray(p) + np.asarray(u), params, updates)
    got = faster_rcnn_variables_from_state_dict(state.model.state_dict())["params"]
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        node, old = _leaf(got, path), _leaf(params, path)
        change = np.abs(w - old).max()
        rounding = np.spacing(np.abs(old).max())
        assert change > 0 and np.abs(node - w).max() <= STEP_TOL * change + rounding, (
            jax.tree_util.keystr(path))


def test_bf16_loss_matches_jax_bf16_loss(frozen_grads):
    """bf16 convolutions and products on both sides (flax ``dtype=bfloat16``,
    the port's autocast), the losses in float32 on the port outside the
    autocast region: each term within ``BF16_TOL``."""
    pm0, v, _, _ = _built("frozen")
    x, targets = frozen_grads["x"], frozen_grads["targets"]
    jm = J.FasterRCNNFPN(num_classes=3, image_h=H, image_w=W, num_proposals=K,
                         dtype=jnp.bfloat16)
    anchors = jnp.asarray(J.rpn_anchor_grid(H, W, jm.strides, jm.anchor_sizes, jm.aspect_ratios))
    want = jax.jit(lambda v, x: (lambda o: {**J.rcnn_loss(o, targets, 3),
                                            **J.rpn_loss(o, anchors, targets)})(
        jm.apply(v, x, train=False)))(v, x)
    pm = copy.deepcopy(pm0)
    tt = {k: _t(a) for k, a in targets.items()}
    with torch.no_grad():
        with torch.autocast("cpu", dtype=torch.bfloat16):
            out = pm(_t(x))
        assert out["scores"].dtype == torch.bfloat16
        got = {**P.rcnn_loss(out, tt, 3), **P.rpn_loss(out, pm.anchors, tt)}
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= BF16_TOL * max(abs(float(want[k])), 1e-3), (
            k, float(got[k]), float(want[k]))


def test_trainer_refusals_and_device():
    cfg = pconfig.FCOSConfig(num_classes=3, image_h=H, image_w=W)
    with pytest.raises(TypeError, match="DataMesh"):
        RCNNTrainer(cfg, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="batch_sync"):
        RCNNTrainer(cfg, backbone_norm="batch_sync", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            RCNNTrainer(cfg)
    trainer = RCNNTrainer(cfg, device="cpu")
    a, b = trainer.dropout_generator(3), trainer.dropout_generator(3)
    assert torch.equal(torch.rand(4, generator=a), torch.rand(4, generator=b))
    assert not torch.equal(torch.rand(4, generator=trainer.dropout_generator(4)),
                           torch.rand(4, generator=trainer.dropout_generator(3)))


# ---------------------------------------------------------------------------
# the weights


def _reference_state_dict(seed: int = 10) -> dict:
    """A state dict with the reference's keys (torchvision ResNet-34 + a
    4-level FPN in the newer ``.0.`` names, the RPN head in the
    ``Conv2dNormActivation`` layout, the unused ``fc``, an anchor buffer
    and BatchNorm's ``num_batches_tracked``), random values."""
    from tests.torch_oracles import TorchResNet34, _TorchFPN

    gen = torch.Generator().manual_seed(seed)
    sd = {f"backbone.body.{k}": v for k, v in TorchResNet34().state_dict().items()}
    sd["backbone.body.fc.weight"], sd["backbone.body.fc.bias"] = torch.zeros(1000, 512), \
        torch.zeros(1000)
    for k, v in _TorchFPN(in_channels=(64, 128, 256, 512)).state_dict().items():
        block, i, leaf = k.rsplit(".", 2)
        sd[f"backbone.fpn.{block}.{i}.0.{leaf}"] = v
    shapes = {"rpn.head.conv.0.0": (256, 256, 3, 3), "rpn.head.cls_logits": (3, 256, 1, 1),
              "rpn.head.bbox_pred": (12, 256, 1, 1), "roi_heads.box_head.fc6": (1024, 12544),
              "roi_heads.box_head.fc7": (1024, 1024),
              "roi_heads.box_predictor.cls_score": (3, 1024),
              "roi_heads.box_predictor.bbox_pred": (12, 1024),
              "roi_heads.box_predictor.hand_lr_layer": (3, 1024),
              "roi_heads.box_predictor.hand_dydx_layer": (9, 1024),
              "roi_heads.box_predictor.hand_contact_state_layer.0": (32, 1024),
              "roi_heads.box_predictor.hand_contact_state_layer.3": (15, 32)}
    for name, shape in shapes.items():
        sd[f"{name}.weight"] = torch.randn(shape, generator=gen) * 0.01
        sd[f"{name}.bias"] = torch.randn(shape[0], generator=gen) * 0.01
    for k in list(sd):
        if k.endswith(("running_mean", "running_var", ".bias")) and "backbone" in k:
            sd[k] = sd[k] + torch.rand(sd[k].shape, generator=gen)
    sd["rpn.anchor_generator.cell_anchors"] = torch.zeros(3, 4)
    return sd


def test_reference_checkpoint_loads_and_converts_like_jax():
    sd = _reference_state_dict()
    assert any(k.endswith("num_batches_tracked") for k in sd)
    model = P.FasterRCNNFPN(3, H, W, K)
    model.load_state_dict(faster_rcnn_state_dict(sd), strict=True)
    got = faster_rcnn_variables_from_state_dict(model.state_dict())
    want = convert_faster_rcnn({k: v.numpy() for k, v in sd.items()})
    assert leaves_equal(got, jax.tree_util.tree_map(np.ascontiguousarray, want))


def test_flax_round_trips_are_exact():
    pm, v, _, _ = _built("batch")
    sd = faster_rcnn_state_dict_from_flax(v)
    assert sd.keys() == pm.state_dict().keys()
    assert all(torch.equal(sd[k], pm.state_dict()[k]) for k in sd)
    assert leaves_equal(faster_rcnn_variables_from_state_dict(sd), v)
