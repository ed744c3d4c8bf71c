"""The port's last data and ops modules against the JAX package's, on the
CPU: the offset field, the bilinear crop, the batched Procrustes alignment,
colour jitter, the multi-camera deprojection and sequence loader, the E2E
sample source (MANO regeneration included), and the slice as a whole: E2E
items -> the pipeline -> the COCO evaluator.

Inputs come from numpy seeds and reach both sides as numpy arrays; trees
are written by the test (``data/image_io.py`` PNGs, YAML by hand, the
synthetic DexYCB tree, whose planted hands need frames of 480x640; the
slice's detector runs at 48x64 on the frames it resamples). Everything runs
on one torch thread.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handnet_tpu import config as jconfig
from handnet_tpu.convert.torch_weights import convert_a2j, convert_fcos
from handnet_tpu.data import e2e_data as je2e
from handnet_tpu.data import imgtrans as jimgtrans
from handnet_tpu.data import sequence as jseq
from handnet_tpu.data.dexycb import DexYCBDataset as JaxDexYCB
from handnet_tpu.eval import coco_det as jcoco
from handnet_tpu.eval import voc as jvoc
from handnet_tpu.models import mano as jmano
from handnet_tpu.models.pipeline import HandNetPipeline as JaxPipeline
from handnet_tpu.ops import crop_resize as jcrop
from handnet_tpu.ops import geometry as jgeom
from handnet_tpu.ops import offset_field as joffset
from handnet_tpu_torch import config as pconfig
from handnet_tpu_torch.convert.from_flax import pipeline_state_dict_from_flax
from handnet_tpu_torch.data import dexycb, e2e_data, image_io, imgtrans, sequence
from handnet_tpu_torch.data.synthetic import make_synthetic_dexycb
from handnet_tpu_torch.eval import coco_det, voc
from handnet_tpu_torch.models import mano
from handnet_tpu_torch.models.pipeline import HandNetPipeline
from handnet_tpu_torch.ops import crop_resize, geometry, offset_field
from chip_smoke import e2e_coco
from torch_port_fixtures import assert_close, randomize_norms


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# ops

@pytest.mark.parametrize("size,feature", [(32, 32), (40, 16), (17, 12)])
def test_offset_field_matches_jax(size, feature):
    """``joint2offset`` and ``offset2joint_softmax`` against JAX's on joints
    and depth that leave some pixels masked (depth >= 0.99) and resampled
    by the module's own nearest rule: float32 on both sides, to 1e-5 (the
    same operations; the sums' order differs)."""
    rng = np.random.default_rng(size)
    jt = rng.uniform(-0.6, 0.6, size=(2, 4, 3)).astype(np.float32)
    img = rng.uniform(-0.5, 1.2, size=(2, 1, size, size)).astype(np.float32)
    want = np.asarray(joffset.joint2offset(jnp.asarray(jt), jnp.asarray(img), 0.8, feature))
    got = offset_field.joint2offset(_t(jt), _t(img), 0.8, feature)
    assert tuple(got.shape) == want.shape == (2, 16, feature, feature)
    assert_close(got, want, rtol=1e-5, atol=1e-5)
    back = np.asarray(joffset.offset2joint_softmax(jnp.asarray(want), jnp.asarray(img), 0.8))
    assert_close(offset_field.offset2joint_softmax(_t(want), _t(img), 0.8), back,
                 rtol=1e-5, atol=1e-5)
    assert offset_field._resize_nearest(_t(img), feature).tolist() == np.asarray(
        joffset._resize_nearest(jnp.asarray(img), feature)).tolist()


def test_offset_field_round_trip():
    """tests/test_misc_modules.py's round trip: encode -> decode gives the
    joints back within the field's resolution (0.1)."""
    jt = np.random.default_rng(0).uniform(-0.5, 0.5, size=(2, 4, 3)).astype(np.float32)
    img = torch.zeros(2, 1, 32, 32)
    back = offset_field.offset2joint_softmax(offset_field.joint2offset(_t(jt), img, 0.8, 32),
                                             img, 0.8)
    assert_close(back, jt, rtol=0, atol=0.1)


@pytest.mark.parametrize("mode", ["nearest", "bilinear"])
@pytest.mark.parametrize("channels", [None, 1, 3])
def test_batch_crop_resize_matches_jax(mode, channels):
    """Both modes over boxes inside, across and beyond the image, a box of
    one pixel and a reversed one (clamped to length 1): nearest bit for
    bit (a gather), bilinear to 1e-5 (float32 weights, the same order)."""
    rng = np.random.default_rng(3)
    shape = (6, 20, 30) + ((channels,) if channels else ())
    images = rng.uniform(0, 2, size=shape).astype(np.float32)
    boxes = np.array([[2, 3, 15, 12], [0, 0, 29, 19], [-5, -4, 40, 30], [7, 7, 7, 7],
                      [20, 15, 5, 3], [25, 1, 31, 22]], np.int32)
    want = np.asarray(jcrop.batch_crop_resize(jnp.asarray(images), jnp.asarray(boxes), 11, 9,
                                              mode))
    got = crop_resize.batch_crop_resize(_t(images), _t(boxes), 11, 9, mode)
    assert tuple(got.shape) == want.shape
    if mode == "nearest":
        assert np.array_equal(got.numpy(), want)
    else:
        assert_close(got, want, rtol=1e-5, atol=1e-5)
        single = crop_resize.crop_resize_bilinear(_t(images[1:2]), _t(boxes[1:2]), 11, 9)
        one = np.asarray(jcrop.crop_resize_bilinear(jnp.asarray(images[1]),
                                                    jnp.asarray(boxes[1]), 11, 9))
        assert_close(single[0], one, rtol=1e-5, atol=1e-5)


def test_align_w_scale_matches_jax_and_numpy():
    """The batched Procrustes alignment ``[..., N, 3]`` against JAX's and
    the per-sample numpy version: float32 to 1e-4 of the coordinates'
    scale (an SVD of 3x3 matrices, computed by other libraries), float64
    against numpy to 1e-10."""
    rng = np.random.default_rng(5)
    gt = rng.normal(size=(2, 4, 21, 3)) * 50
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    pred = 1.3 * gt @ q.T + rng.normal(size=3) * 10 + rng.normal(size=gt.shape)
    want = np.asarray(jgeom.align_w_scale(jnp.asarray(gt, jnp.float32),
                                          jnp.asarray(pred, jnp.float32)))
    got = geometry.align_w_scale(_t(gt).float(), _t(pred).float())
    assert got.dtype == torch.float32 and tuple(got.shape) == gt.shape
    assert_close(got, want, rtol=0, atol=1e-4 * np.abs(gt).max())
    per_sample = np.stack([geometry.align_w_scale_np(g, p) for g, p in
                           zip(gt.reshape(-1, 21, 3), pred.reshape(-1, 21, 3))])
    assert_close(geometry.align_w_scale(_t(gt), _t(pred)).reshape(-1, 21, 3), per_sample,
                 rtol=0, atol=1e-10)


@pytest.mark.parametrize("kind", ["all", "brightness", "contrast", "saturation", "hue", "none"])
def test_color_jitter_bit_equal_at_a_seed(kind):
    """``color_jitter`` with one ``default_rng(seed)`` on each side gives the
    same image bit for bit: the same draws in the same order (the shuffle
    included), then the same float32 arithmetic; the rng ends in the same
    state."""
    factors = {"brightness": 0.4, "contrast": 0.4, "saturation": 0.4, "hue": 0.1}
    kwargs = factors if kind == "all" else {k: v for k, v in factors.items() if k == kind}
    img = np.random.default_rng(9).uniform(size=(12, 16, 3)).astype(np.float32)
    for seed in range(4):
        j_rng, p_rng = np.random.default_rng(seed), np.random.default_rng(seed)
        want = jimgtrans.color_jitter(img, rng=j_rng, **kwargs)
        got = imgtrans.color_jitter(img, rng=p_rng, **kwargs)
        assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)
        assert j_rng.uniform() == p_rng.uniform()
    for fn in ("adjust_brightness", "adjust_contrast", "adjust_saturation", "adjust_hue"):
        arg = 0.07 if fn == "adjust_hue" else 1.3
        assert np.array_equal(getattr(imgtrans, fn)(img, arg), getattr(jimgtrans, fn)(img, arg))


# ---------------------------------------------------------------------------
# the multi-camera sequence loader

def _cameras(rng, c):
    """Inverse intrinsics and cam->world transforms of ``c`` cameras."""
    inv_k, c2w = [], []
    for _ in range(c):
        k = np.array([[rng.uniform(300, 700), 0, rng.uniform(20, 40)],
                      [0, rng.uniform(300, 700), rng.uniform(10, 30)], [0, 0, 1]], np.float32)
        inv_k.append(np.linalg.inv(k))
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        t = np.eye(4, dtype=np.float32)
        t[:3, :3], t[:3, 3] = q, rng.normal(size=3)
        c2w.append(t)
    return np.stack(inv_k).astype(np.float32), np.stack(c2w).astype(np.float32)


def test_deproject_depth_matches_jax_and_float64():
    """``[C, H, W]`` -> ``[C, H*W, 3]`` points and ``[C, H*W]`` masks: the
    masks exactly, the points against JAX's and against the float64 numpy
    product to 1e-5 m (float32, depths up to 2 m, translations ~1 m)."""
    rng = np.random.default_rng(11)
    depth = rng.uniform(0.2, 2.0, size=(3, 24, 32)).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < 0.2] = 0.0
    inv_k, c2w = _cameras(rng, 3)
    want_pts, want_mask = (np.asarray(a) for a in jseq.deproject_depth(
        jnp.asarray(depth), jnp.asarray(inv_k), jnp.asarray(c2w)))
    pts, mask = sequence.deproject_depth(_t(depth), _t(inv_k), _t(c2w))
    assert pts.dtype == torch.float32 and tuple(pts.shape) == (3, 24 * 32, 3)
    assert np.array_equal(mask.numpy(), want_mask) and not mask.all()
    assert_close(pts, want_pts, rtol=0, atol=1e-5)
    ys, xs = np.meshgrid(np.arange(24), np.arange(32), indexing="ij")
    pix = np.stack([xs, ys, np.ones_like(xs)], -1).reshape(-1, 3).astype(np.float64)
    cam = np.einsum("cij,nj->cni", inv_k.astype(np.float64), pix) * depth.reshape(3, -1, 1)
    world = (np.einsum("cij,cnj->cni", c2w[:, :3, :3].astype(np.float64), cam)
             + c2w[:, None, :3, 3])
    assert_close(pts, world, rtol=0, atol=1e-5)


SERIALS = ["836212060125", "839512060362"]


@pytest.fixture(scope="module")
def sequence_tree(tmp_path_factory):
    """Two cameras, three frames of 24x32 16-bit depth PNGs, their
    intrinsics, a meta.yml naming the extrinsics and an extrinsics.yml (12
    row-major numbers per camera, serials quoted as in DexYCB)."""
    root = tmp_path_factory.mktemp("sequence")
    rng = np.random.default_rng(13)
    seq = "20200709-subject-01/20200709_141754"
    for i, s in enumerate(SERIALS):
        (root / seq / s).mkdir(parents=True)
        for f in range(3):
            image_io.write_png(root / seq / s / f"aligned_depth_to_color_{f:06d}.png",
                               rng.integers(0, 2500, size=(24, 32)).astype(np.uint16))
        intr = root / "calibration" / "intrinsics"
        intr.mkdir(parents=True, exist_ok=True)
        (intr / f"{s}_640x480.yml").write_text(
            f"color:\n  fx: {600.5 + i}\n  fy: {601.25 - i}\n  ppx: {15.5 + i}\n"
            f"  ppy: {11.75}\ndepth:\n  fx: 1.0\n")
    _, c2w = _cameras(rng, 2)
    extr = root / "calibration" / "extrinsics_20200702_151821"
    extr.mkdir(parents=True)
    (extr / "extrinsics.yml").write_text(
        "extrinsics:\n" + "".join(f"  '{s}': [{', '.join(repr(float(v)) for v in m[:3].ravel())}]\n"
                                  for s, m in zip(SERIALS, c2w))
        + "master: '836212060125'\n")
    (root / seq / "meta.yml").write_text(
        "serials:\n" + "".join(f"- '{s}'\n" for s in SERIALS)
        + "extrinsics: '20200702_151821'\nnum_frames: 3\n")
    return str(root), seq


def test_sequence_loader_from_meta_matches_jax(sequence_tree):
    """``sequence_loader_from_meta`` over the written tree: inverse
    intrinsics and extrinsics equal to JAX's loader's, the frame count, each
    frame's depth (the port's PNG decode == cv2's) and its points (1e-5 m)
    and masks."""
    root, seq = sequence_tree
    want = jseq.sequence_loader_from_meta(root, seq, SERIALS)
    got = sequence.sequence_loader_from_meta(root, seq, SERIALS, device="cpu")
    assert got.num_frames == want.num_frames == 3
    assert np.array_equal(got.inv_k.numpy(), np.asarray(want.inv_k))
    assert np.array_equal(got.cam_to_world.numpy(), np.asarray(want.cam_to_world))
    for frame in (0, 2):
        assert np.array_equal(got.depth_frames(frame), want.depth_frames(frame))
        pts, mask = got.points(frame)
        want_pts, want_mask = want.points(frame)
        assert np.array_equal(mask.numpy(), np.asarray(want_mask))
        assert_close(pts, np.asarray(want_pts), rtol=0, atol=1e-5)
    assert np.array_equal(sequence.load_extrinsics(root, "20200702_151821", SERIALS[::-1])[0],
                          jseq.load_extrinsics(root, "20200702_151821", SERIALS[::-1])[0])


def test_sequence_loader_defaults_to_the_card(sequence_tree, monkeypatch):
    """Without a device the loader deprojects on the card: where there is
    none it raises instead of carrying on on the CPU."""
    root, seq = sequence_tree
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sequence.sequence_loader_from_meta(root, seq, SERIALS)


# ---------------------------------------------------------------------------
# E2E samples and the slice

H, W, CROP = 48, 64, 32        # the detector's input and the A2J crop


@pytest.fixture(scope="module")
def e2e_tree(tmp_path_factory):
    """The synthetic DexYCB tree (two sequences of three frames) and both
    packages' datasets over it."""
    root = str(tmp_path_factory.mktemp("e2e"))
    make_synthetic_dexycb(root, n_sequences=2, n_frames=3)
    return (dexycb.DexYCBDataset("s0", "train", data_dir=root),
            JaxDexYCB("s0", "train", data_dir=root))


@pytest.fixture(scope="module")
def e2e_items(e2e_tree):
    """Every item of both packages' ``E2EDataSource`` with a synthetic right
    MANO layer each (the same draws at one seed): the port's on the CPU."""
    ds, jds = e2e_tree
    layer = mano.ManoLayer(mano.ManoAssets.synthetic(np.random.default_rng(0), side="right"),
                           flat_hand_mean=True, device="cpu")
    jlayer = jmano.ManoLayer(jmano.ManoAssets.synthetic(np.random.default_rng(0), side="right"),
                             flat_hand_mean=True)
    src = e2e_data.E2EDataSource(ds, dexycb.refine_indices(ds), mano_layers={"right": layer})
    jsrc = je2e.E2EDataSource(jds, dexycb.refine_indices(ds), mano_layers={"right": jlayer})
    assert len(src) == len(jsrc) >= 4
    return [src[i] for i in range(len(src))], [jsrc[i] for i in range(len(jsrc))]


def test_e2e_items_match_jax(e2e_items):
    """Every key of every item: the frames (the port's JPEG and PNG decoders
    == cv2), the detection target, the joints, the hand box and intrinsics
    bit for bit; the regenerated mesh ``verts3d [778, 3]`` in metres to
    1e-6 m (float32 MANO on both sides, summed in another order)."""
    got_items, want_items = e2e_items
    for got, want in zip(got_items, want_items):
        assert sorted(got) == sorted(want)
        assert got["image"].shape == (480, 640, 3) and got["verts3d"].shape == (778, 3)
        for key in want:
            if key == "verts3d":
                assert_close(got[key], want[key], rtol=1e-5, atol=1e-6, err_msg=key)
            else:
                assert got[key].dtype == want[key].dtype, key
                assert np.array_equal(got[key], want[key]), key


def _slice_cfg(module):
    return module.HandNetConfig(
        a2j=module.A2JConfig(crop_h=CROP, crop_w=CROP, head_features=32),
        fcos=module.FCOSConfig(image_h=H, image_w=W, max_detections=8, num_classes=3,
                               ext=False, score_thresh=0.0, fpn_channels=64, num_convs=2),
        pipeline=module.PipelineConfig(crop_size=CROP))


def test_slice_e2e_items_pipeline_coco_matches_jax(e2e_items):
    """E2E items -> ``HandNetPipeline`` (float32, seeded weights with random
    norms, score threshold 0; its detector at 48x64 on the resampled
    frames) -> ``CocoDetEvaluator`` bbox and keypoints (``chip_smoke.py``'s
    ``e2e_coco``, the card's chain), against the same chain in JAX on the
    same items and weights: found and
    boxes exact, scores to 1e-5, joints to 1e-3 px (as
    tests/test_torch_port_pipeline.py holds the slice), and the COCO
    numbers equal. The GT boxes and joints given back as detections score
    AP 1.0 on both sides."""
    got_items, want_items = e2e_items
    port = HandNetPipeline(_slice_cfg(pconfig), seed=2, device="cpu")
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    flax_vars = {part: randomize_norms(convert({k[len(part) + 1:]: v for k, v in sd.items()
                                                if k.startswith(part + ".")}), seed=7)
                 for part, convert in (("detector", convert_fcos), ("a2j", convert_a2j))}
    port.load_state_dict(pipeline_state_dict_from_flax(flax_vars), strict=True)

    def frames(items):
        return tuple(np.stack([it[k] for it in items]) for k in ("image", "depth", "paras"))

    got = {k: v.numpy() for k, v in port(*(_t(a) for a in frames(got_items))).items()}
    jax_pipe = JaxPipeline(_slice_cfg(jconfig))
    want = jax.jit(lambda v, im, d, p: jax_pipe(v, im, d, p))(
        jax.tree_util.tree_map(jnp.asarray, flax_vars),
        *(jnp.asarray(a) for a in frames(want_items)))
    want = {k: np.asarray(v) for k, v in want.items()}
    assert want["found"].any()     # random weights find a hand in some frames
    for key in ("found", "boxes"):
        assert np.array_equal(got[key], want[key]), key
    assert_close(got["scores"], want["scores"], rtol=1e-5, atol=1e-6)
    assert_close(got["joints_uvd_full"], want["joints_uvd_full"], rtol=1e-4, atol=1e-3)

    # the COCO records and evaluations of the card's [e2e_eval] phase
    bbox, kpts = e2e_coco(got_items, got, coco_det.CocoDetEvaluator, voc)
    assert (bbox, kpts) == e2e_coco(want_items, want, jcoco.CocoDetEvaluator, jvoc)
    assert all(0.0 <= r[k] <= 1.0 for r in (bbox, kpts) for k in ("AP", "AR"))
    perfect = e2e_coco(got_items, None, coco_det.CocoDetEvaluator, voc)
    assert perfect[0]["AP"] == perfect[1]["AP"] == 1.0
