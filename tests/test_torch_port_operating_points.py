"""The benchmark's operating points in bf16, and the port's calibration baker.

``bench.py`` composes a profile (fast, parity, turbo) with the int8 convs
(none, dynamic, static) into nine operating points that serve in bfloat16.
Here the compositions that no other CPU test holds in bf16 run through
``handnet_tpu_torch`` ``HandNetPipeline`` and ``handnet_tpu``
``HandNetPipeline.__call__`` (jitted), both in bfloat16, on the same
weights and frames: turbo with dynamic and with static int8, parity with
dynamic int8 on frames that ``preprocess`` resizes, and fast with the
mesh head. Each config is ``config.PROFILES[profile]`` (the dicts that
``test_torch_port_geometry.py`` holds equal to bench's YAML files) with
the int8 convs composed on, at test size: a 64x96 detector with 64-wide
FPN and towers, 48^2 crops with 64-wide A2J heads, a 64-wide PoseNet.

Weights start from the port's seeded init, get random norm statistics and
reach JAX through the JAX package's converters (``convert_fcos``,
``convert_a2j``, ``convert_pose2mesh``), as in
``test_torch_port_mesh.py``'s ``weights`` fixture. Frames are seeded
numpy.

In bf16 a box corner is a bf16 head output times a stride, truncated to
an integer pixel: where the two frameworks' convolutions round one
output apart by an ulp, a corner can fall on either side of an integer
(JAX's own bf16 and float32 crop boxes part so on most found frames of
the int8 cases), and where two hand detections score within rounding of
each other the argmax can take either. So the int8 cases hold ``found``
on every frame and sides, boxes and crops exactly on at least half of
the found frames, and the joints and scores on those frames; the
docstrings give the counts measured.

The baker (``handnet_tpu_torch/tools/bake_bench_calibration.py``) is held
to the literal ``default_rng(0)`` draw of the JAX tool and to
``nn.quant.load_calibration``.
"""

import hashlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handnet_tpu import config as jconfig
from handnet_tpu.convert.torch_weights import convert_a2j, convert_fcos, convert_pose2mesh
from handnet_tpu.models.pipeline import HandNetPipeline as JaxPipeline
from handnet_tpu.nn import quant as jquant
from handnet_tpu_torch import config as pconfig
from handnet_tpu_torch.convert.from_flax import flax_calibration_key, pipeline_state_dict_from_flax
from handnet_tpu_torch.models.pipeline import HandNetPipeline
from handnet_tpu_torch.nn import quant as pquant
from handnet_tpu_torch.tools import bake_bench_calibration as baker
from torch_port_fixtures import assert_close, randomize_norms

REPO = Path(__file__).resolve().parent.parent
H, W, CROP, WIDTH, HID = 64, 96, 48, 64, 64
PARITY_FRAME = (48, 64)          # resized to 64x85 and padded to 64x96
SMALL = {"fcos": {"image_h": H, "image_w": W, "fpn_channels": WIDTH, "max_detections": 8,
                  "score_thresh": 0.0},
         "a2j": {"crop_h": CROP, "crop_w": CROP, "head_features": WIDTH},
         "pipeline": {"crop_size": CROP}, "pose2mesh": {"posenet_hid": HID}}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread, as the other port tests: small forwards, and
    other test processes beside this one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _merge(base: dict, extra: dict) -> dict:
    out = dict(base)
    for key, value in extra.items():
        out[key] = (_merge(base[key], value) if isinstance(value, dict)
                    and isinstance(base.get(key), dict) else value)
    return out


def _cfg(module, profile, quant=None, with_mesh=False):
    """``PROFILES[profile]`` with ``quant`` composed on as ``resolve_config``
    does, at test size, as a config of ``module`` (either package)."""
    overrides = _merge(pconfig.PROFILES[profile], SMALL)
    if quant is not None:
        overrides = _merge(overrides, {"fcos": {"quant": quant}, "a2j": {"quant": quant}})
    if with_mesh:
        overrides = _merge(overrides, {"pipeline": {"with_mesh": True}})
    return module.load_config(overrides=overrides)


def _frames(seed, batch, hw=(H, W)):
    h, w = hw
    rng = np.random.default_rng(seed)
    images = rng.uniform(size=(batch, h, w, 3)).astype(np.float32)
    depth = rng.uniform(0.3, 1.0, size=(batch, h, w)).astype(np.float32)
    paras = np.tile([600.0, 600.0, w / 2, h / 2], (batch, 1)).astype(np.float32)
    return images, depth, paras


def _weights(profile, seed, with_mesh=False):
    """Port state dict of the static-int8 layout (act_amax left out), the
    same weights as JAX variables, and the act_amax names."""
    sd = {k: v.numpy() for k, v in HandNetPipeline(
        _cfg(pconfig, profile, "static", with_mesh), seed=seed, device="cpu").state_dict().items()}

    def part(prefix):
        return {k[len(prefix):]: v for k, v in sd.items()
                if k.startswith(prefix) and not k.endswith(".act_amax")}

    flax_vars = {"detector": randomize_norms(convert_fcos(part("detector.")), seed=4),
                 "a2j": randomize_norms(convert_a2j(part("a2j.")), seed=5)}
    if with_mesh:
        flax_vars["pose2mesh"] = randomize_norms(convert_pose2mesh(part("pose2mesh.")), seed=6)
    return (pipeline_state_dict_from_flax(flax_vars), flax_vars,
            sorted(k for k in sd if k.endswith(".act_amax")))


@pytest.fixture(scope="module")
def weights4():
    """The 4-conv towers (fast, parity) with the mesh head: seed 0, the
    ``weights`` fixture of ``test_torch_port_mesh.py``."""
    return _weights("fast", 0, with_mesh=True)


@pytest.fixture(scope="module")
def weights2():
    """turbo's 2-conv towers, seed 3: the first seed whose random weights
    take the found path on every frame tried (at seeds 0 and 4 another
    class ranks first on every frame, at 1 and 2 on most)."""
    return _weights("turbo", 3)


def _port(cfg, weights, dtype=torch.bfloat16):
    pipe = HandNetPipeline(cfg, dtype=dtype, device="cpu")
    state = {k: v for k, v in weights[0].items()
             if cfg.pipeline.with_mesh or not k.startswith("pose2mesh.")}
    if pipe.needs_calibration():
        state.update({k: torch.zeros(()) for k in weights[2]})
    pipe.load_state_dict(state, strict=True)
    return pipe


def _jax_vars(weights, with_mesh, calibration=None):
    """The JAX variables; with a calibration file, every quant_stats leaf
    present and loaded from it (the port's amaxes, through the npz map)."""
    tree = jax.tree_util.tree_map(np.asarray, {k: v for k, v in weights[1].items()
                                               if with_mesh or k != "pose2mesh"})
    if calibration is None:
        return jax.tree_util.tree_map(jnp.asarray, tree)
    for name in weights[2]:
        model, _, *keys, leaf = flax_calibration_key(name).split("/")
        node = tree[model].setdefault("quant_stats", {})
        for key in keys:
            node = node.setdefault(key, {})
        node[leaf] = np.float32(0.0)
    return jquant.load_calibration(calibration, jax.tree_util.tree_map(jnp.asarray, tree))


def _numpy(out):
    return {k: np.asarray(jnp.asarray(v, jnp.float32) if v.dtype == jnp.bfloat16 else v)
            for k, v in out.items()}


def run_case(weights, profile, quant, frames, with_mesh=False, calib_frames=None,
             tmp_path=None, jax_dtype=jnp.bfloat16):
    """The port in bf16 and JAX in ``jax_dtype`` on ``frames``; a static
    config is calibrated by the port on ``calib_frames`` and JAX loads the
    port's file. Returns both outputs as float32/bool numpy arrays."""
    port = _port(_cfg(pconfig, profile, quant, with_mesh), weights)
    calibration = None
    if port.needs_calibration():
        port.calibrate(torch.from_numpy(calib_frames[0]), torch.from_numpy(calib_frames[1]))
        pquant.assert_calibrated(port)
        calibration = str(tmp_path / f"{profile}_calib.npz")
        pquant.save_calibration(calibration, port)
    got = {k: v.float().numpy() if v.is_floating_point() else v.numpy()
           for k, v in port(*map(torch.from_numpy, frames)).items()}
    jax_pipe = JaxPipeline(_cfg(jconfig, profile, quant, with_mesh), dtype=jax_dtype)
    want = jax.jit(lambda v, im, d, p: jax_pipe(v, im, d, p))(
        _jax_vars(weights, with_mesh, calibration), *map(jnp.asarray, frames))
    return got, _numpy(want)


def hold_bf16(got, want, tol, min_agree):
    """``found`` equal on every frame; sides, boxes and crops equal on at
    least ``min_agree`` found frames (the agreeing frames); on every
    agreeing frame, scores and joints within ``tol`` (``{key: atol}``)."""
    assert sorted(got) == sorted(want)
    found = want["found"]
    assert np.array_equal(got["found"], found) and found.any()
    agree = np.array([all(np.array_equal(got[k][i], want[k][i])
                          for k in ("sides", "boxes", "crops")) for i in range(len(found))])
    assert (agree & found).sum() >= min_agree, f"found {found}, agreeing {agree}"
    for key, atol in tol.items():
        assert_close(got[key][agree], want[key][agree], rtol=0, atol=atol, err_msg=key)


# ---------------------------------------------------------------------------
# bf16 against JAX's bf16


@pytest.fixture(scope="module")
def fast_mesh(weights4):
    """fast with the mesh head, bf16 on both sides, 2 frames (one compile
    of each pipeline serves the fast outputs and the head's)."""
    return run_case(weights4, "fast", None, _frames(0, 2), with_mesh=True)


def test_fast_bf16_matches_jax_bf16(fast_mesh):
    """fast in bf16 (no int8): found, sides, boxes and crops exact on both
    frames; scores to 1e-2 (measured 2.2e-3; JAX's bf16 against its float32
    on the same frames 5.3e-4), joints_uvd and joints_uvd_full to 2e-2 px
    (measured 5.3e-3 / 1.0e-3; JAX's own 3.2e-3 / 4.8e-4), joints_xyz to
    1 mm (measured 0.27; JAX's own 0.20)."""
    got, want = fast_mesh
    assert want["found"].all()
    hold_bf16(got, want, {"scores": 1e-2, "joints_uvd": 2e-2, "joints_uvd_full": 2e-2,
                          "joints_xyz": 1.0}, min_agree=2)


def test_mesh_head_bf16_matches_jax_bf16(fast_mesh):
    """The with_mesh head in bf16: verts to 3e-2 of their scale, verts_xyz
    to 3e-2 of its scale. Measured 1.08e-2 (verts) and 1.16e-2 (verts_xyz),
    against JAX's own bf16-to-float32 distances of 5.6e-3 and 5.8e-3 on the
    same frames.

    The port is twice as far from JAX's bf16 as JAX's bf16 is from its
    float32, by design: the port keeps the Laplacians and the
    feature-resize matrices in bf16 and runs the Chebyshev products in bf16
    (``handnet_tpu_torch/models/pose2mesh.py``), where JAX keeps them float32
    (``handnet_tpu/models/pose2mesh.py``) and its type promotion runs those
    products in float32. Products in float32 would put the head's 689.6
    GFLOP per B=128 call off the bf16 tensor cores (at least 10.3 ms at 67
    TFLOP/s against 3.52 ms measured on an H100), to come within JAX's
    own bf16 rounding, which XLA's float32 inside its CPU fusions sets."""
    got, want = fast_mesh
    for key in ("verts", "verts_xyz"):
        scale = float(np.abs(want[key]).max())
        assert_close(got[key], want[key], rtol=0, atol=3e-2 * scale, err_msg=key)
    hold_bf16(got, want, {}, min_agree=2)


INT8_TOL = {"scores": 1e-2, "joints_uvd": 0.1, "joints_uvd_full": 0.1, "joints_xyz": 5.0}


def test_turbo_dynamic_int8_bf16_matches_jax_bf16(weights2):
    """turbo (2-conv towers) with dynamic int8, 6 frames: found equal on
    every frame; on the agreeing frames scores to 1e-2, joints to 0.1 px
    and 5 mm (``INT8_TOL``). Measured: found on 6 of 6 frames; sides, boxes
    and crops equal on 4 of them (JAX's bf16 and its float32 agree on 3);
    there scores 2.6e-3, joints_uvd 2.5e-2 px, joints_uvd_full 7.9e-3 px,
    joints_xyz 1.7 mm (JAX's bf16 against its float32 on its 3 frames:
    1.0e-2, 2.7e-2, 1.1e-2, 1.7)."""
    got, want = run_case(weights2, "turbo", True, _frames(11, 6))
    hold_bf16(got, want, INT8_TOL, min_agree=(want["found"].sum() + 1) // 2)


def test_turbo_static_int8_bf16_matches_jax_bf16(weights2, tmp_path):
    """turbo with static int8, calibrated by the port in bf16 on 4 frames
    (JAX loads the port's file: the same scales), 6 frames: as the dynamic
    case. Measured: found on 6 of 6, equal on 4 (JAX's own bf16 and float32
    on 3); there scores 1.8e-3, joints_uvd 2.8e-2 px, joints_uvd_full
    1.2e-2 px, joints_xyz 2.9 mm (JAX's own on its 3: 5.3e-3, 2.7e-2,
    7.2e-3, 2.6)."""
    got, want = run_case(weights2, "turbo", "static", _frames(13, 6),
                         calib_frames=_frames(12, 4), tmp_path=tmp_path)
    hold_bf16(got, want, INT8_TOL, min_agree=(want["found"].sum() + 1) // 2)


def test_parity_dynamic_int8_bf16_matches_jax_bf16(weights4):
    """parity with dynamic int8 on 48x64 frames, which ``preprocess``
    resizes to 64x85 and pads to 64x96 (the resize branch), 6 frames: as the
    turbo cases. Measured: found on 6 of 6, equal on 5 (JAX's own bf16 and
    float32 on 1); there scores 3.5e-3, joints_uvd 1.7e-2 px,
    joints_uvd_full 5.4e-3 px, joints_xyz 1.1 mm (JAX's own on its 1 frame:
    3.1e-3, 8.7e-3, 3.3e-3, 1.2)."""
    got, want = run_case(weights4, "parity", True, _frames(14, 6, PARITY_FRAME))
    hold_bf16(got, want, INT8_TOL, min_agree=(want["found"].sum() + 1) // 2)


# ---------------------------------------------------------------------------
# the baker


@pytest.mark.parametrize("n,full,h,w", [(2, 5, 4, 6), (5, 5, 3, 7), (1, 3, 2, 2)])
def test_bench_frames_equal_the_literal_draw(n, full, h, w):
    """The JAX tool's draw: all ``full`` images, then all ``full`` depth
    maps, from ``default_rng(0)``, the first ``n`` of each kept."""
    rng = np.random.default_rng(0)
    images = rng.uniform(size=(full, h, w, 3)).astype(np.float32)
    depth = rng.uniform(0.3, 1.0, size=(full, h, w)).astype(np.float32)
    got = baker.bench_frames(n, full, h, w)
    assert got[0].dtype == got[1].dtype == np.float32
    assert np.array_equal(got[0], images[:n]) and np.array_equal(got[1], depth[:n])
    with pytest.raises(ValueError):
        baker.bench_frames(full + 1, full, h, w)


def test_baked_file_loads_bit_equal_to_live(tmp_path):
    """``bake`` calibrates in bf16 on the first 2 benchmark frames; its file,
    read by ``nn.quant.load_calibration`` into a fresh pipeline of the same
    seed, sets every amax to the live one's and gives outputs bit-equal to
    the live-calibrated pipeline's."""
    cfg = _cfg(pconfig, "quant_static")
    out = tmp_path / "calib.npz"
    live, count = baker.bake(cfg, str(out), batch=2, device="cpu")
    fresh = HandNetPipeline(cfg, dtype=torch.bfloat16, device="cpu")
    assert pquant.load_calibration(str(out), fresh) == count == len(list(
        pquant._static_layers(fresh)))
    pquant.assert_calibrated(fresh)
    for (name, a), (_, b) in zip(pquant._static_layers(live), pquant._static_layers(fresh)):
        assert torch.equal(a.act_amax, b.act_amax), name
    frames = tuple(map(torch.from_numpy, _frames(7, 2)))
    got, want = fresh(*frames), live(*frames)
    for key, value in want.items():
        assert torch.equal(got[key], value), key


def _jax_file_digest():
    return hashlib.sha256((REPO / "configs" / "bench_calib.npz").read_bytes()).hexdigest()


def test_main_writes_where_out_says(tmp_path, monkeypatch, capsys):
    """``main`` on the CPU (quant_static shrunk to test size) writes the
    file ``--out`` names (into a directory it makes) and prints its count;
    ``bake`` of turbo with static int8 writes turbo's fewer layers. Neither
    the default path nor any run touches the JAX package's
    ``configs/bench_calib.npz``, and ``bake`` refuses that path."""
    monkeypatch.setattr(baker, "resolve_config", lambda profile: _cfg(pconfig, profile))
    before = _jax_file_digest()
    assert Path(baker.DEFAULT_OUT).resolve() != baker.JAX_FILE
    assert baker.parse_args([]).out == str(baker.DEFAULT_OUT)
    out = tmp_path / "new" / "calib"
    assert baker.main(["--device", "cpu", "--batch", "1", "--out", str(out)]) == 0
    count = len(np.load(str(out) + ".npz").files)
    assert capsys.readouterr().out.strip() == f"saved {count} calibration scalars -> {out}.npz"
    _, turbo = baker.bake(_cfg(pconfig, "turbo", "static"), str(tmp_path / "turbo.npz"),
                          batch=1, device="cpu")
    assert turbo == count - 4       # two towers of 2 convs instead of 4
    with pytest.raises(ValueError, match="JAX package"):
        baker.bake(_cfg(pconfig, "quant_static"), str(REPO / "configs" / "bench_calib"),
                   device="cpu")
    assert _jax_file_digest() == before


def test_main_needs_the_card_by_default(tmp_path, monkeypatch):
    """Without ``--device`` the baker runs on the card, and where there is
    none it raises instead of calibrating on the CPU."""
    monkeypatch.setattr(baker, "resolve_config", lambda profile: _cfg(pconfig, profile))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        baker.main(["--out", str(tmp_path / "calib.npz")])
    assert not (tmp_path / "calib.npz").exists()
