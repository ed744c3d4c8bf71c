"""Config tree of the port: the same frozen dataclasses as ``handnet_tpu.config``.

The classes are copied field for field rather than imported, so that a run of
the port loads nothing of the JAX package; ``tests/test_torch_port_pipeline.py``
asserts the two trees are equal. Operating points are Python dicts (``FAST``,
``QUANT``, ``QUANT_STATIC``, ``PARITY``, ``TURBO``; :func:`resolve_config`
picks one by name) because the machines that serve the port may lack
``pyyaml``; ``load_config`` still reads a YAML file when asked to.

``FCOSConfig.gn_fast_variance`` is kept for equality with the YAML profiles,
but the port ignores it: its tower GroupNorm always takes the exact two-pass
statistics of the CUDA kernel (``ops/cuda_gn.py``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


@dataclass(frozen=True)
class A2JConfig:
    """A2J pose regressor (reference: a2j/a2j.py:212-224, config/a2j.yaml)."""

    num_joints: int = 21
    crop_h: int = 176
    crop_w: int = 176
    in_channels: int = 1           # 1 = depth, 4 = RGBD
    backbone: str = "resnet50"
    stride: int = 16
    # 16 anchors per cell at offsets {2,6,10,14}^2 (reference a2j/anchor.py:7-24)
    anchor_offsets: Tuple[int, ...] = (2, 6, 10, 14)
    head_features: int = 256
    spatial_factor: float = 0.5
    reg_loss_factor: float = 3.0
    is_3d: bool = True
    # True pairs regression channel 0 with the row grid, as converted
    # reference checkpoints need (reference a2j/a2j.py:86-89)
    transposed_anchors: bool = False
    # int8 tower and backbone convs (nn/quant.py): False, True/"dynamic"
    # or "static" (calibrated per-layer activation scales)
    quant: Any = False

    @property
    def num_anchors(self) -> int:
        return len(self.anchor_offsets) ** 2

    @property
    def feat_h(self) -> int:
        return self.crop_h // self.stride

    @property
    def feat_w(self) -> int:
        return self.crop_w // self.stride


@dataclass(frozen=True)
class FCOSConfig:
    """FCOS hand detector (reference: fcos_utils/fcos.py:455-511)."""

    num_classes: int = 3
    ext: bool = True               # 100DOH extension heads (contact/dxdy)
    backbone: str = "resnet34"
    fpn_channels: int = 256
    strides: Tuple[int, ...] = (8, 16, 32)
    num_convs: int = 4
    prior_prob: float = 0.01
    image_h: int = 800
    image_w: int = 1088
    image_mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    image_std: Tuple[float, float, float] = (0.229, 0.224, 0.225)
    center_sampling_radius: float = 1.5
    score_thresh: float = 0.7      # hard mask in postprocess (reference fcos.py:600)
    nms_thresh: float = 0.6
    post_nms_thresh: float = 0.3   # reference fcos.py:635
    max_detections: int = 64       # static detection budget (pad + validity mask)
    s2d_stem: bool = False
    quant: Any = False             # int8 backbone/FPN/tower convs (nn/quant.py)
    gn_fast_variance: bool = False  # ignored by the port (module docstring)


@dataclass(frozen=True)
class PipelineConfig:
    """Fused detect->crop->pose pipeline (reference handnet_pipeline/handnet_pipeline.py)."""

    pad_percent: float = 0.4       # reference handnet_pipeline.py:93
    crop_size: int = 176
    rgbd: bool = False
    hand_label: Optional[int] = None  # default: num_classes - 1 (reference :74)
    with_mesh: bool = False
    quant_margin: float = 0.1


@dataclass(frozen=True)
class ManoConfig:
    """MANO hand LBS model (reference: manopth/manolayer.py:13-274)."""

    ncomps: int = 45
    flat_hand_mean: bool = False
    center_idx: Optional[int] = None
    use_pca: bool = True


@dataclass(frozen=True)
class Pose2MeshConfig:
    """Pose2Mesh lifter+GCN (reference: pose2mesh/lib/models/*)."""

    num_joints: int = 21
    posenet_hid: int = 4096
    posenet_stages: int = 2
    dropout: float = 0.5
    cheby_order: int = 3
    num_mesh_verts: int = 778


@dataclass(frozen=True)
class TrainConfig:
    """Optimization recipes (reference config/a2j.yaml:8-30, trainval_net_fcos.py:195-204)."""

    batch_size: int = 64
    lr: float = 3.5e-4
    weight_decay: float = 1e-4
    epochs: int = 45
    lr_step: int = 10
    lr_gamma: float = 0.2
    warmup_epochs: int = 0
    optimizer: str = "adamw"
    bf16: bool = True
    seed: int = 0
    dp_devices: Optional[int] = None


@dataclass(frozen=True)
class HandNetConfig:
    a2j: A2JConfig = field(default_factory=A2JConfig)
    fcos: FCOSConfig = field(default_factory=FCOSConfig)
    pipeline: PipelineConfig = field(default_factory=PipelineConfig)
    mano: ManoConfig = field(default_factory=ManoConfig)
    pose2mesh: Pose2MeshConfig = field(default_factory=Pose2MeshConfig)
    train: TrainConfig = field(default_factory=TrainConfig)


# The ``fast`` operating point: configs/fast.yaml as a dict. 480x640 native
# frames (no resample), ResNet-34+FPN-256 detector with 3 classes and no
# extension heads, 176^2 A2J crops, batch 128 in bf16.
FAST: Dict[str, Any] = {
    "fcos": {"num_classes": 3, "ext": False, "image_h": 480, "image_w": 640,
             "score_thresh": 0.7, "nms_thresh": 0.5, "post_nms_thresh": 0.3,
             "gn_fast_variance": True},
    "pipeline": {"pad_percent": 0.4, "crop_size": 176},
    "train": {"batch_size": 128, "bf16": True},
}

# configs/quant.yaml and configs/quant_static.yaml: the fast geometry with
# int8 convs, per-sample dynamic activation scales (QUANT) or calibrated
# static ones (QUANT_STATIC, the JAX package's benchmark default; serve it
# after HandNetPipeline.calibrate or nn.quant.load_calibration).
QUANT: Dict[str, Any] = {**FAST, "fcos": {**FAST["fcos"], "quant": True},
                         "a2j": {"quant": True}}
QUANT_STATIC: Dict[str, Any] = {**FAST, "fcos": {**FAST["fcos"], "quant": "static"},
                                "a2j": {"quant": "static"}}

# configs/parity.yaml: the reference's inference geometry. A 480x640 frame
# is resized to 800x1067 (GeneralizedRCNNTransform's min-800 resize) and
# padded to 800x1088; exact GroupNorm variance (the port's only kind).
PARITY: Dict[str, Any] = {
    "fcos": {"num_classes": 3, "ext": False, "image_h": 800, "image_w": 1088,
             "score_thresh": 0.7, "nms_thresh": 0.5, "post_nms_thresh": 0.3},
    "pipeline": {"pad_percent": 0.4, "crop_size": 176},
    "train": {"batch_size": 128, "bf16": True},
}

# configs/turbo.yaml: the fast geometry with 2-conv head towers instead of
# the reference's 4 (a reduced-FLOP design for models trained from scratch).
TURBO: Dict[str, Any] = {**FAST, "fcos": {**FAST["fcos"], "num_convs": 2}}

PROFILES: Dict[str, Dict[str, Any]] = {
    "fast": FAST, "parity": PARITY, "turbo": TURBO, "quant": QUANT,
    "quant_static": QUANT_STATIC}


def _replace_recursive(cfg: Any, overrides: Dict[str, Any]) -> Any:
    kwargs = {}
    for key, value in overrides.items():
        if not hasattr(cfg, key):
            raise KeyError(f"unknown config key {key!r} for {type(cfg).__name__}")
        current = getattr(cfg, key)
        if dataclasses.is_dataclass(current) and isinstance(value, dict):
            kwargs[key] = _replace_recursive(current, value)
        else:
            kwargs[key] = type(current)(value) if isinstance(current, tuple) else value
    return dataclasses.replace(cfg, **kwargs)


def load_config(overrides: Optional[Dict[str, Any]] = None,
                yaml_path: Optional[str] = None) -> HandNetConfig:
    """Build a config, optionally merged from a YAML file and/or a dict
    (``load_config(overrides=FAST)`` is the fast profile without YAML). The
    file is read by ``data/yaml_lite.py``, the port's reader of the YAML
    subset its files use, not by pyyaml."""
    cfg = HandNetConfig()
    if yaml_path is not None:
        from handnet_tpu_torch.data import yaml_lite

        cfg = _replace_recursive(cfg, yaml_lite.load(yaml_path) or {})
    if overrides:
        cfg = _replace_recursive(cfg, overrides)
    return cfg


def resolve_config(profile: str = "quant_static", quant: Any = None) -> HandNetConfig:
    """An operating point by name, with the int8 conv path composed onto it:
    the counterpart of ``bench.py``'s ``resolve_config`` (``PROFILE`` and
    ``QUANT``).

    ``profile`` is a key of :data:`PROFILES`; ``quant`` is None (the
    profile's own convs), True (dynamic int8, ``QUANT=1``) or ``"static"``
    (calibrated int8, ``QUANT=static``), set on both the detector and A2J.
    ``bench.py``'s ``GNFV`` switch has no counterpart: the port's tower
    GroupNorm always takes the exact statistics of its kernel, so there is
    nothing to switch.
    """
    if profile not in PROFILES:
        raise KeyError(f"unknown profile {profile!r}; one of {sorted(PROFILES)}")
    if quant not in (None, True, "static"):
        raise ValueError(f"quant must be None, True or 'static', got {quant!r}")
    cfg = load_config(overrides=PROFILES[profile])
    if quant is not None:
        cfg = _replace_recursive(cfg, {"fcos": {"quant": quant}, "a2j": {"quant": quant}})
    return cfg


def pipeline_outputs(cfg: HandNetConfig, with_xyz: bool = False) -> Tuple[str, ...]:
    """The keys of ``HandNetPipeline.forward``'s dict under ``cfg``;
    ``with_xyz`` when the call passes ``paras``. A server or an artifact
    refuses to be asked for any other."""
    keys = ["joints_uvd", "boxes", "crops", "found", "scores", "sides", "joints_uvd_full"]
    if with_xyz:
        keys.append("joints_xyz")
    if cfg.pipeline.with_mesh:
        keys += ["verts", "verts_xyz"] if with_xyz else ["verts"]
    return tuple(keys)
