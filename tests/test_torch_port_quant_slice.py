"""Calibration and the int8 slice: ``handnet_tpu_torch`` ``HandNetPipeline``
with ``quant="static"`` (the ``quant_static`` profile at test size) against
``handnet_tpu`` ``HandNetPipeline.calibrate``/``__call__``.

The weights start from the port's seeded init, get random norm statistics
and reach the JAX side through the JAX package's converters, as in
``test_torch_port_pipeline.py``. Frames are 64x96 with 48x48 crops; the FPN
and head towers are 64 channels wide to keep the CPU time down. Both sides
run in float32 on the CPU.
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
from handnet_tpu.models.pipeline import HandNetPipeline as JaxPipeline
from handnet_tpu.nn import quant as jquant
from handnet_tpu_torch import config as pconfig
from handnet_tpu_torch.convert.from_flax import (flax_calibration_key,
                                                 pipeline_state_dict_from_flax,
                                                 port_calibration_name)
from handnet_tpu_torch.models.pipeline import HandNetPipeline
from handnet_tpu_torch.nn import quant as pquant
from torch_port_fixtures import assert_close, randomize_norms

REPO = Path(__file__).resolve().parent.parent
H, W, CROP, WIDTH = 64, 96, 48, 64
N_QUANT_LAYERS = 113  # 49 in the detector, 64 in A2J (configs/bench_calib.npz)


def _cfg(module, quant="static", score_thresh=0.0):
    return module.HandNetConfig(
        a2j=module.A2JConfig(crop_h=CROP, crop_w=CROP, head_features=WIDTH, quant=quant),
        fcos=module.FCOSConfig(image_h=H, image_w=W, max_detections=8, num_classes=3,
                               ext=False, score_thresh=score_thresh, fpn_channels=WIDTH,
                               quant=quant),
        pipeline=module.PipelineConfig(crop_size=CROP))


def _strip_amax(state_dict, prefix):
    return {k[len(prefix):]: v for k, v in state_dict.items()
            if k.startswith(prefix) and not k.endswith(".act_amax")}


@pytest.fixture(scope="module")
def weights():
    """Port state dict (act_amax zero) and the same weights as JAX variables
    (params and batch_stats; calibration adds quant_stats)."""
    sd = {k: v.numpy() for k, v in HandNetPipeline(_cfg(pconfig), seed=0, device="cpu")
          .state_dict().items()}
    flax_vars = {
        # convert_fcos/convert_a2j read reference checkpoints, which hold no
        # act_amax: the calibration buffers are compared through the npz map
        "detector": randomize_norms(convert_fcos(_strip_amax(sd, "detector.")), seed=4),
        "a2j": randomize_norms(convert_a2j(_strip_amax(sd, "a2j.")), seed=5),
    }
    state_dict = pipeline_state_dict_from_flax(flax_vars)
    state_dict.update({k: torch.zeros(()) for k in sd if k.endswith(".act_amax")})
    return state_dict, flax_vars


def _frames(seed, batch=2):
    rng = np.random.default_rng(seed)
    images = rng.uniform(size=(batch, H, W, 3)).astype(np.float32)
    depth = rng.uniform(0.3, 1.0, size=(batch, H, W)).astype(np.float32)
    paras = np.tile([600.0, 600.0, W / 2, H / 2], (batch, 1)).astype(np.float32)
    return images, depth, paras


def _port(weights, quant="static", score_thresh=0.0):
    pipe = HandNetPipeline(_cfg(pconfig, quant, score_thresh), device="cpu")
    pipe.load_state_dict(weights[0], strict=True)
    return pipe


def _amaxes(pipe):
    return {name: float(buf) for name, buf in pipe.named_buffers()
            if name.endswith(".act_amax")}


def _jax_amaxes(variables):
    return {port_calibration_name(key): float(np.asarray(leaf))
            for key, leaf in jquant._walk_quant_stats(variables)}


@pytest.fixture(scope="module")
def jax_pipe():
    return JaxPipeline(_cfg(jconfig))


@pytest.fixture(scope="module")
def jax_vars(weights):
    """The JAX variables with every quant_stats leaf present (zero): the
    tree keeps one structure through calibration, so jit compiles once."""
    tree = jax.tree_util.tree_map(np.asarray, weights[1])
    for name in weights[0]:
        if name.endswith(".act_amax"):
            model, _, *path, leaf = flax_calibration_key(name).split("/")
            node = tree[model].setdefault("quant_stats", {})
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = np.float32(0.0)
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def calibrated(weights, jax_vars, tmp_path_factory):
    """The port calibrated on one batch with the default margin, and the
    JAX variables with the port's calibration loaded through the npz map
    (so that a forward comparison starts from the same static scales)."""
    images, depth, _ = _frames(0)
    port = _port(weights)
    port.calibrate(torch.from_numpy(images), torch.from_numpy(depth))
    path = str(tmp_path_factory.mktemp("cal") / "port_cal.npz")
    pquant.save_calibration(path, port)
    return port, jquant.load_calibration(path, jax_vars)


def _assert_amaxes_match(got, want, exact_share):
    """act_amax by port name, port against JAX: all within rtol 3e-2 and at
    least ``exact_share`` of them within rtol 1e-5.

    Not all within 1e-5: the float layers between the int8 convs (the stem
    conv, the norms) round differently in the two frameworks in the last
    bit (the detector stem's output is bit-equal on ~75% of its elements),
    and an int8 layer turns a last-bit difference at a rounding tie into a
    whole quantization step. Those steps are sparse, but once one falls in
    the receptive field of a layer's largest activation, that layer's amax
    moves by up to ~2e-2 (27-33 of the detector's 49 match to 1e-5 here).
    On the same crops, A2J's 64 match to 1e-5. Per layer, calibration is
    exact:
    ``test_calibrate_folds_what_each_layer_sees`` here and
    ``test_quantconv_calibration_mode_matches_jax`` against JAX.
    """
    assert sorted(got) == sorted(want) and all(v > 0 for v in got.values())
    names = sorted(got)
    g, w = np.array([got[n] for n in names]), np.array([want[n] for n in names])
    assert_close(g, w, rtol=3e-2, atol=0)
    exact = np.abs(g - w) <= 1e-5 * np.abs(w)
    assert exact.mean() >= exact_share, [n for n, e in zip(names, exact) if not e]


@pytest.fixture(scope="module")
def jax_a2j_calibrate(jax_pipe):
    """JAX's A2J calibration step (``handnet_tpu/models/pipeline.py:226-235``)
    on given crops: ``(a2j variables, crops) -> quant_stats update``."""
    return jax.jit(lambda v, crops: jax_pipe.a2j.module.apply(
        v, crops, train=False, mutable=["quant_stats"])[1])


@pytest.mark.parametrize("margin", [0.0, None], ids=["margin0", "default"])
@pytest.mark.parametrize("batches", [1, 2])
def test_calibrate_matches_jax(weights, jax_pipe, jax_vars, jax_a2j_calibrate,
                               batches, margin):
    """One batch, or two in one call (amaxes fold with max over both and
    the margin is applied once), with margin 0 or the config's 0.1.

    The detector's amaxes are held against JAX's ``calibrate``. A2J's are
    held against JAX's A2J calibration step run on the port's crops: with
    random weights the boxes are thin, so the detector's sparse last-bit
    differences can move a box by a pixel, and a calibration on other crops
    is not comparable."""
    frames = [_frames(1), _frames(2)][:batches]
    port = _port(weights)
    port.calibrate([torch.from_numpy(f[0]) for f in frames],
                   [torch.from_numpy(f[1]) for f in frames], margin=margin)
    want = jax_pipe.calibrate(jax_vars, [jnp.asarray(f[0]) for f in frames],
                              [jnp.asarray(f[1]) for f in frames], margin=margin)
    got = _amaxes(port)
    detector = {k: v for k, v in _jax_amaxes(want).items() if k.startswith("detector.")}
    _assert_amaxes_match({k: got[k] for k in detector}, detector, exact_share=0.5)

    # A2J calibrates on the crops of the detector before its margin
    raw = _port(weights)
    raw.calibrate([torch.from_numpy(f[0]) for f in frames],
                  [torch.from_numpy(f[1]) for f in frames], margin=0.0)
    a2j = dict(jax_vars["a2j"])
    with torch.no_grad():
        for im, d, _ in frames:
            crops = raw._detect_and_crop(torch.from_numpy(im), torch.from_numpy(d))["crops"]
            a2j.update(jax_a2j_calibrate(a2j, jnp.asarray(crops.numpy())))
    margin = jax_pipe.cfg.pipeline.quant_margin if margin is None else margin
    a2j = _jax_amaxes({"a2j": jquant.apply_margin(a2j, margin) if margin else a2j})
    assert len(detector) + len(a2j) == N_QUANT_LAYERS
    _assert_amaxes_match({k: got[k] for k in a2j}, a2j, exact_share=1.0)


def test_calibrate_folds_what_each_layer_sees(weights):
    """Teacher-forced: every act_amax is exactly the largest |x| its layer
    saw over both batches, A2J calibrated on the crops of the calibrated,
    static detector, and a margin multiplies every amax by (1 + margin) in
    float32, as the JAX package's apply_margin."""
    frames = [tuple(torch.from_numpy(a) for a in _frames(seed)[:2]) for seed in (1, 2)]
    port = _port(weights)
    seen, crops = {}, []

    def record(name):
        def hook(module, args):
            # the detector also serves A2J's crops, static and not calibrating
            if module.calibrating:
                seen.setdefault(name, []).append(float(args[0].abs().max()))
        return hook

    hooks = [m.register_forward_pre_hook(record(name)) for name, m in port.named_modules()
             if isinstance(m, pquant.QuantConv)]
    hooks.append(port.a2j.register_forward_pre_hook(
        lambda m, args: crops.append(args[0].clone())))
    port.calibrate([f[0] for f in frames], [f[1] for f in frames], margin=0.0)
    for h in hooks:
        h.remove()
    amaxes = _amaxes(port)
    assert len(seen) == len(amaxes) == N_QUANT_LAYERS
    for name, values in seen.items():
        assert amaxes[f"{name}.act_amax"] == max(values)
    assert len(crops) == 2
    with torch.no_grad():
        for (im, d), got in zip(frames, crops):
            assert torch.equal(got, port._detect_and_crop(im, d)["crops"])
    pquant.apply_margin(port, 0.25)
    for name, value in _amaxes(port).items():
        assert value == float(np.float32(amaxes[name]) * np.float32(1.25)), name


def test_quant_static_slice_matches_jax_found_path(calibrated, jax_pipe):
    """The calibrated int8 slice on the found path (score threshold 0),
    both sides with the same calibration. found, sides, boxes and crops
    exact; scores to 1e-5; joints to 1e-3 px / 1e-2 mm, as the float slice
    (observed 1.5e-5 px). The float stem and prediction convs differ
    between the frameworks in the last bit, and at a rounding tie that
    moves an int8 activation by a whole step (see _assert_amaxes_match);
    the joints average such steps over the decode's anchors."""
    port, jax_variables = calibrated
    frames = _frames(3)
    got = {k: v.numpy() for k, v in port(*(torch.from_numpy(a) for a in frames)).items()}
    want = jax.jit(lambda v, im, d, p: jax_pipe(v, im, d, p))(
        jax_variables, *(jnp.asarray(a) for a in frames))
    want = {k: np.asarray(v) for k, v in want.items()}
    assert sorted(got) == sorted(want)
    assert want["found"].all()
    for key in ("found", "sides", "boxes", "crops"):
        assert got[key].shape == want[key].shape, key
        assert np.array_equal(got[key], want[key]), key
    assert_close(got["scores"], want["scores"], rtol=1e-5, atol=1e-6)
    for key in ("joints_uvd", "joints_uvd_full"):
        assert_close(got[key], want[key], rtol=0, atol=1e-3, err_msg=key)
    assert_close(got["joints_xyz"], want["joints_xyz"], rtol=0, atol=1e-2)


def test_quant_dynamic_slice_matches_jax(weights):
    """The dynamic int8 profile (per-sample scales, no calibration) on the
    found path: found, sides, boxes and crops exact, joints to 5e-2 px
    (observed 1.3e-2). Looser than the static slice: every layer's scale
    is its input's own amax, so a last-bit difference in an activation can
    move the scale and with it every quantized value of the sample."""
    frames = _frames(4)
    port = HandNetPipeline(_cfg(pconfig, quant=True), device="cpu")
    port.load_state_dict({k: v for k, v in weights[0].items()
                          if not k.endswith(".act_amax")}, strict=True)
    assert not port.needs_calibration()
    got = {k: v.numpy() for k, v in port(*(torch.from_numpy(a) for a in frames)).items()}
    jpipe = JaxPipeline(_cfg(jconfig, quant=True))
    want = jax.jit(lambda v, im, d, p: jpipe(v, im, d, p))(
        jax.tree_util.tree_map(jnp.asarray, weights[1]), *(jnp.asarray(a) for a in frames))
    want = {k: np.asarray(v) for k, v in want.items()}
    assert want["found"].all()
    for key in ("found", "sides", "boxes", "crops"):
        assert np.array_equal(got[key], want[key]), key
    for key in ("joints_uvd", "joints_uvd_full"):
        assert_close(got[key], want[key], rtol=0, atol=5e-2, err_msg=key)


def test_npz_round_trips_between_packages(calibrated, weights, jax_vars, tmp_path):
    """Port -> npz -> JAX and JAX -> npz -> port carry every act_amax
    exactly, under the JAX package's keys."""
    port, jax_variables = calibrated
    path = str(tmp_path / "port_cal")
    assert pquant.save_calibration(path, port) == N_QUANT_LAYERS
    assert _jax_amaxes(jquant.load_calibration(path, jax_vars)) == _amaxes(port)

    path = str(tmp_path / "jax_cal.npz")
    jquant.save_calibration(path, jax_variables)
    other = _port(weights)
    assert pquant.load_calibration(path, other) == N_QUANT_LAYERS
    assert _amaxes(other) == _jax_amaxes(jax_variables)
    pquant.assert_calibrated(other)


def test_state_dict_carries_quant_stats(calibrated):
    """pipeline_state_dict_from_flax turns every quant_stats act_amax into
    the port buffer of the same layer; the result loads strictly."""
    port, jax_variables = calibrated
    state = pipeline_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jax_variables))
    amaxes = {k: float(v) for k, v in state.items() if k.endswith(".act_amax")}
    assert amaxes == _jax_amaxes(jax_variables) and len(amaxes) == N_QUANT_LAYERS
    other = HandNetPipeline(_cfg(pconfig), device="cpu")
    other.load_state_dict(state, strict=True)
    assert _amaxes(other) == _amaxes(port)


def test_calibration_guards(weights, tmp_path):
    """A fresh static pipeline fails assert_calibrated; a calibration file
    does not load into a pipeline without those layers; calibrate is a
    no-op for a float config."""
    fresh = _port(weights)
    assert fresh.needs_calibration()
    with pytest.raises(ValueError, match="never calibrated"):
        pquant.assert_calibrated(fresh)
    path = str(tmp_path / "cal")
    np.savez(path, **{"detector/quant_stats/fpn/lateral_9/act_amax": np.float32(1.0)})
    with pytest.raises(KeyError):
        pquant.load_calibration(path, fresh)
    floaty = HandNetPipeline(_cfg(pconfig, quant=False), device="cpu")
    before = {k: v.clone() for k, v in floaty.state_dict().items()}
    floaty.calibrate(*(torch.from_numpy(a) for a in _frames(0)[:2]))
    assert all(torch.equal(before[k], v) for k, v in floaty.state_dict().items())
    pquant.assert_calibrated(floaty)
    with pytest.raises(ValueError, match="no static"):
        pquant.save_calibration(path, floaty)


def test_bench_calib_loads_into_full_width_quant_static():
    """configs/bench_calib.npz (written by the JAX package) sets all 113
    buffers of a full-width QUANT_STATIC pipeline (construction only)."""
    cfg = pconfig.load_config(overrides=pconfig.QUANT_STATIC)
    pipe = HandNetPipeline(cfg, device="cpu")
    assert pquant.load_calibration(str(REPO / "configs" / "bench_calib"), pipe) == N_QUANT_LAYERS
    data = np.load(REPO / "configs" / "bench_calib.npz")
    amaxes = _amaxes(pipe)
    assert len(amaxes) == N_QUANT_LAYERS
    assert all(amaxes[port_calibration_name(k)] == float(data[k]) for k in data.files)
    pquant.assert_calibrated(pipe)


def test_quant_profiles_without_yaml():
    """QUANT and QUANT_STATIC build the same configs as their YAML files."""
    for overrides, name in ((pconfig.QUANT, "quant"), (pconfig.QUANT_STATIC, "quant_static")):
        assert dataclasses.asdict(pconfig.load_config(overrides=overrides)) == \
            dataclasses.asdict(jconfig.load_config(yaml_path=str(REPO / "configs" / f"{name}.yaml")))


def test_bf16_pipeline_keeps_int8_master_weights_float32():
    """The bf16 cast leaves every QuantConv's weight and bias float32 (JAX
    quantizes the float32 kernel) and casts the float convs."""
    pipe = HandNetPipeline(_cfg(pconfig), dtype=torch.bfloat16, device="cpu")
    convs = [m for m in pipe.modules() if isinstance(m, torch.nn.Conv2d)]
    quant = [m for m in convs if isinstance(m, pquant.QuantConv)]
    assert len(quant) == N_QUANT_LAYERS
    assert all(m.weight.dtype == torch.float32 for m in quant)
    assert all(m.weight.dtype == torch.bfloat16 for m in convs if m not in quant)
