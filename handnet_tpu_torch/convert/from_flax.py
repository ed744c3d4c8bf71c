"""JAX package variables <-> port state dicts.

The inverse of ``handnet_tpu/convert/torch_weights.py`` ``convert_fcos``
(:122), ``convert_a2j`` (:89), ``convert_faster_rcnn`` (:180) and
``convert_pose2mesh`` (:256): a
``{"params", "batch_stats"}`` tree of numpy (or jax) arrays becomes a state
dict in the reference's torch names, which the port's modules load with
``load_state_dict(strict=True)``. ``convert_fcos(fcos_state_dict_from_flax(v))``
gives back ``v``'s params and batch_stats leaf for leaf, and likewise for
A2J, Faster R-CNN and Pose2Mesh. The other way,
:func:`fcos_variables_from_state_dict`, :func:`a2j_variables_from_state_dict`,
:func:`faster_rcnn_variables_from_state_dict` and
:func:`pose2mesh_variables_from_state_dict` give a port model's state dict
(a trained one too) as the flax tree, which ``train/checkpoints.py`` writes
as the JAX package's params npz.

Layout rules (reversed from the JAX package's converter):
  flax conv kernel [kh, kw, I, O] -> torch weight [O, I, kh, kw]
  flax dense kernel [I, O]        -> torch weight [O, I]
  (Faster R-CNN's fc6: the flax rows flatten the pooled roi [7, 7, C],
   the torch columns [C, 7, 7])
  norm params scale/bias          -> weight/bias
  batch_stats mean/var            -> running_mean/running_var
  quant_stats act_amax            -> act_amax (a static QuantConv's buffer)

:func:`flax_calibration_key` and :func:`port_calibration_name` map between a
pipeline buffer name (``detector.backbone.body.layer1.0.conv1.act_amax``) and
the key of the JAX package's calibration npz
(``detector/quant_stats/backbone/layer1_0/conv1/act_amax``).
:func:`load_params_npz` reads the flat npz trees the JAX package's
``train.checkpoints.save_params_npz`` writes.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Tuple

import numpy as np
import torch

_LEAF = {("params", "kernel"): "weight", ("params", "scale"): "weight",
         ("params", "bias"): "bias", ("batch_stats", "mean"): "running_mean",
         ("batch_stats", "var"): "running_var",
         ("quant_stats", "act_amax"): "act_amax"}
_RESNET_SUB = {"downsample_conv": "downsample.0", "downsample_bn": "downsample.1"}
_A2J_HEADS = {"classification": "classificationModel", "regression": "regressionModel",
              "depth": "DepthRegressionModel"}


def _leaves(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _resnet_name(path: Tuple[str, ...]) -> str:
    """flax ResNet module path -> torchvision name: ``layer1_0/downsample_conv``
    -> ``layer1.0.downsample.0``."""
    head, *rest = path
    m = re.fullmatch(r"layer(\d)_(\d+)", head)
    if not m:
        return ".".join(path)
    return ".".join([f"layer{m.group(1)}", m.group(2)] + [_RESNET_SUB.get(p, p) for p in rest])


_FCOS_OUTPUTS = {"cls_logits": "classification_head.cls_logits",
                 "hand_lr": "classification_head.hand_lr_layer",
                 "hand_contact": "classification_head.hand_contact_state_layer",
                 "hand_dxdy": "classification_head.hand_dydx_layer",
                 "bbox_reg": "regression_head.bbox_reg",
                 "bbox_ctrness": "regression_head.bbox_ctrness"}


def _fcos_name(path: Tuple[str, ...]) -> str:
    top, *rest = path
    if top == "backbone":
        return "backbone.body." + _resnet_name(tuple(rest))
    if top == "fpn":
        kind, i = rest[0].rsplit("_", 1)
        block = {"lateral": "inner_blocks", "output": "layer_blocks"}[kind]
        return f"backbone.fpn.{block}.{i}"
    if top == "head":
        name = rest[0]
        if name in ("cls_tower", "reg_tower"):
            branch = "classification" if name == "cls_tower" else "regression"
            m = re.fullmatch(r"(conv|gn)(\d+)", rest[1])
            idx = 3 * int(m.group(2)) + (0 if m.group(1) == "conv" else 1)
            return f"head.{branch}_head.conv.{idx}"
        return "head." + _FCOS_OUTPUTS[name]
    raise KeyError(f"unmapped fcos path: {'/'.join(path)}")


def _a2j_name(path: Tuple[str, ...]) -> str:
    top, *rest = path
    if top == "backbone":
        return "Backbone.model." + _resnet_name(tuple(rest))
    if top in _A2J_HEADS:
        return f"{_A2J_HEADS[top]}." + ".".join(rest)
    raise KeyError(f"unmapped a2j path: {'/'.join(path)}")


def _state_dict(variables, module_name: Callable[[Tuple[str, ...]], str]
                ) -> Dict[str, torch.Tensor]:
    out = {}
    for collection in ("params", "batch_stats", "quant_stats"):
        for path, value in _leaves(variables.get(collection, {})):
            value = np.asarray(value)
            if path[-1] == "kernel" and value.ndim == 4:
                value = value.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            elif path[-1] == "kernel" and value.ndim == 2:
                value = value.T                      # [in, out] -> [out, in]
            key = f"{module_name(path[:-1])}.{_LEAF[(collection, path[-1])]}"
            out[key] = torch.from_numpy(np.array(value, order="C"))
    return out


def _resnet_path(name: str) -> Tuple[str, ...]:
    """Inverse of :func:`_resnet_name`."""
    m = re.fullmatch(r"layer(\d)\.(\d+)\.(.+)", name)
    if not m:
        return tuple(name.split("."))
    rest = m.group(3)
    for flax_name, torch_name in _RESNET_SUB.items():
        if rest == torch_name:
            rest = flax_name
    return (f"layer{m.group(1)}_{m.group(2)}", *rest.split("."))


def _fcos_path(name: str) -> Tuple[str, ...]:
    """Inverse of :func:`_fcos_name`: port module name -> flax path."""
    if name.startswith("backbone.body."):
        return ("backbone",) + _resnet_path(name[len("backbone.body."):])
    m = re.fullmatch(r"backbone\.fpn\.(inner|layer)_blocks\.(\d+)", name)
    if m:
        return ("fpn", f"{'lateral' if m.group(1) == 'inner' else 'output'}_{m.group(2)}")
    m = re.fullmatch(r"head\.(classification|regression)_head\.conv\.(\d+)", name)
    if m and int(m.group(2)) % 3 < 2:  # [Conv, GN, ReLU] triplets
        tower = "cls_tower" if m.group(1) == "classification" else "reg_tower"
        layer, kind = divmod(int(m.group(2)), 3)
        return ("head", tower, f"{('conv', 'gn')[kind]}{layer}")
    for flax_name, torch_name in _FCOS_OUTPUTS.items():
        if name == f"head.{torch_name}":
            return ("head", flax_name)
    raise KeyError(f"unmapped fcos module: {name}")


def _a2j_path(name: str) -> Tuple[str, ...]:
    """Inverse of :func:`_a2j_name`: port module name -> flax path."""
    if name.startswith("Backbone.model."):
        return ("backbone",) + _resnet_path(name[len("Backbone.model."):])
    top, _, rest = name.partition(".")
    for flax_name, torch_name in _A2J_HEADS.items():
        if top == torch_name:
            return (flax_name, *rest.split("."))
    raise KeyError(f"unmapped a2j module: {name}")


_POSENET_SUB = {"bn1": "batch_norm1", "bn2": "batch_norm2"}


def _pose2mesh_name(path: Tuple[str, ...]) -> str:
    """flax Pose2Mesh path -> the reference's FlatPose2Mesh name:
    ``pose_lifter/stage0/bn1`` -> ``pose_lifter.linear_stages.0.batch_norm1``,
    ``pose2mesh/cl3/bn`` -> ``pose2mesh.bn.3``, ``pose2mesh/cl3`` ->
    ``pose2mesh.cl.3``."""
    top, *rest = path
    if top == "pose_lifter":
        m = re.fullmatch(r"stage(\d+)", rest[0])
        if m:
            return ".".join(["pose_lifter.linear_stages", m.group(1),
                             *(_POSENET_SUB.get(p, p) for p in rest[1:])])
        return ".".join(path)
    if top == "pose2mesh":
        m = re.fullmatch(r"cl(\d+)", rest[0])
        if m:
            return f"pose2mesh.{'bn' if rest[1:] == ['bn'] else 'cl'}.{m.group(1)}"
        return ".".join(path)
    raise KeyError(f"unmapped pose2mesh path: {'/'.join(path)}")


def _pose2mesh_path(name: str) -> Tuple[str, ...]:
    """Inverse of :func:`_pose2mesh_name`: port module name -> flax path."""
    m = re.fullmatch(r"pose_lifter\.linear_stages\.(\d+)\.(\w+)", name)
    if m:
        sub = {v: k for k, v in _POSENET_SUB.items()}.get(m.group(2), m.group(2))
        return ("pose_lifter", f"stage{m.group(1)}", sub)
    m = re.fullmatch(r"pose2mesh\.(cl|bn)\.(\d+)", name)
    if m:
        return ("pose2mesh", f"cl{m.group(2)}") + (("bn",) if m.group(1) == "bn" else ())
    if name in ("pose_lifter.w1", "pose_lifter.w2", "pose2mesh.fc"):
        return tuple(name.split("."))
    raise KeyError(f"unmapped pose2mesh module: {name}")


_MODELS = {"detector": (_fcos_name, _fcos_path), "a2j": (_a2j_name, _a2j_path)}


def flax_calibration_key(buffer_name: str) -> str:
    """Pipeline buffer ``<model>.<module>.act_amax`` -> JAX npz key
    ``<model>/quant_stats/<flax path>/act_amax``."""
    model, _, rest = buffer_name.partition(".")
    module, _, leaf = rest.rpartition(".")
    if model not in _MODELS or leaf != "act_amax":
        raise KeyError(f"not a pipeline act_amax buffer: {buffer_name}")
    return "/".join((model, "quant_stats", *_MODELS[model][1](module), leaf))


def port_calibration_name(key: str) -> str:
    """JAX npz key ``<model>/quant_stats/<flax path>/act_amax`` -> pipeline
    buffer name ``<model>.<module>.act_amax``."""
    model, collection, *path = key.split("/")
    if model not in _MODELS or collection != "quant_stats" or path[-1:] != ["act_amax"]:
        raise KeyError(f"not a calibration key: {key}")
    return f"{model}.{_MODELS[model][0](tuple(path[:-1]))}.act_amax"


def fcos_state_dict_from_flax(variables) -> Dict[str, torch.Tensor]:
    """FCOS variables (``FCOSSystem.init``) -> port ``FCOS`` state dict."""
    return _state_dict(variables, _fcos_name)


def _variables(state_dict: Dict[str, torch.Tensor],
               module_path: Callable[[str], Tuple[str, ...]]) -> dict:
    """Inverse of :func:`_state_dict`: torch names -> ``{"params",
    "batch_stats"[, "quant_stats"]}`` of float32 numpy arrays."""
    leaf_to_flax = {v: k for k, v in _LEAF.items() if k[1] != "scale"}
    out: dict = {}
    for key, tensor in state_dict.items():
        module, leaf = key.rsplit(".", 1)
        if leaf == "num_batches_tracked":   # ignored, as convert_fcos ignores it
            continue
        value = tensor.detach().float().cpu().numpy()
        collection, name = leaf_to_flax[leaf]
        if leaf == "weight" and value.ndim == 4:
            value = value.transpose(2, 3, 1, 0)      # OIHW -> HWIO
        elif leaf == "weight" and value.ndim == 2:
            value = value.T                          # [out, in] -> [in, out]
        elif leaf == "weight":
            name = "scale"                           # a norm layer's
        node = out.setdefault(collection, {})
        for part in module_path(module):
            node = node.setdefault(part, {})
        node[name] = np.ascontiguousarray(value)
    return out


def fcos_variables_from_state_dict(state_dict: Dict[str, torch.Tensor]) -> dict:
    """Port ``FCOS`` state dict -> the JAX package's FCOS variables
    (``{"params", "batch_stats"}``, numpy): what ``convert_fcos`` gives for
    the same state dict. ``fcos_state_dict_from_flax`` of the result gives
    the state dict back."""
    return _variables(state_dict, _fcos_path)


def a2j_state_dict_from_flax(variables) -> Dict[str, torch.Tensor]:
    """A2J variables (``A2JSystem.init``) -> port ``A2J`` state dict."""
    return _state_dict(variables, _a2j_name)


def a2j_variables_from_state_dict(state_dict: Dict[str, torch.Tensor]) -> dict:
    """Port ``A2J`` state dict (frozen or batch norms; or GroupNorms, whose
    ``weight``/``bias`` become ``params`` ``scale``/``bias`` and which add
    no ``batch_stats``) -> the JAX package's A2J variables: what
    ``convert_a2j`` gives; the inverse of :func:`a2j_state_dict_from_flax`."""
    return _variables(state_dict, _a2j_path)


_RCNN_RPN = {"conv": "conv", "objectness": "cls_logits", "deltas": "bbox_pred"}
_RCNN_PREDICTOR = {"cls_score": "cls_score", "bbox_pred": "bbox_pred",
                   "contact_fc1": "hand_contact_state_layer.0",
                   "contact_fc2": "hand_contact_state_layer.3",
                   "dxdy": "hand_dydx_layer", "hand_side": "hand_lr_layer"}
_FC6 = "roi_heads.box_head.fc6.weight"


def _rcnn_name(path: Tuple[str, ...]) -> str:
    """flax ``FasterRCNNFPN`` path -> the reference's name."""
    top, *rest = path
    if top in ("backbone", "fpn"):
        return _fcos_name(path)
    if top == "rpn_head":
        return f"rpn.head.{_RCNN_RPN[rest[0]]}"
    if top == "box_head":
        return f"roi_heads.box_head.{rest[0]}"
    if top == "predictor":
        return f"roi_heads.box_predictor.{_RCNN_PREDICTOR[rest[0]]}"
    raise KeyError(f"unmapped faster_rcnn path: {'/'.join(path)}")


def _rcnn_path(name: str) -> Tuple[str, ...]:
    """Inverse of :func:`_rcnn_name`."""
    if name.startswith("backbone."):
        return _fcos_path(name)
    for prefix, top, names in (("rpn.head.", "rpn_head", _RCNN_RPN),
                               ("roi_heads.box_head.", "box_head", {"fc6": "fc6", "fc7": "fc7"}),
                               ("roi_heads.box_predictor.", "predictor", _RCNN_PREDICTOR)):
        if name.startswith(prefix):
            for flax_name, torch_name in names.items():
                if name[len(prefix):] == torch_name:
                    return (top, flax_name)
    raise KeyError(f"unmapped faster_rcnn module: {name}")


def _fc6_rows(weight: torch.Tensor, src: str) -> torch.Tensor:
    """fc6's ``[O, 49 C]`` weight with its input columns reordered from the
    pooled roi flattened ``src`` (``"hwc"`` or ``"chw"``) to the other."""
    o, flat = weight.shape
    c = flat // 49
    if src == "hwc":
        return weight.reshape(o, 7, 7, c).permute(0, 3, 1, 2).reshape(o, flat).contiguous()
    return weight.reshape(o, c, 7, 7).permute(0, 2, 3, 1).reshape(o, flat).contiguous()


def faster_rcnn_state_dict_from_flax(variables) -> Dict[str, torch.Tensor]:
    """Faster R-CNN variables (``FasterRCNNFPN.init``) -> port
    ``FasterRCNNFPN`` state dict (fc6's columns in the reference's ``[C, 7,
    7]`` order)."""
    out = _state_dict(variables, _rcnn_name)
    out[_FC6] = _fc6_rows(out[_FC6], "hwc")
    return out


def faster_rcnn_variables_from_state_dict(state_dict: Dict[str, torch.Tensor]) -> dict:
    """Port ``FasterRCNNFPN`` state dict -> the JAX package's Faster R-CNN
    variables: what ``convert_faster_rcnn`` gives; the inverse of
    :func:`faster_rcnn_state_dict_from_flax`."""
    state_dict = dict(state_dict)
    state_dict[_FC6] = _fc6_rows(state_dict[_FC6].detach().cpu(), "chw")
    return _variables(state_dict, _rcnn_path)


def pose2mesh_state_dict_from_flax(variables) -> Dict[str, torch.Tensor]:
    """Pose2Mesh variables -> port ``Pose2Mesh`` state dict."""
    return _state_dict(variables, _pose2mesh_name)


def pose2mesh_variables_from_state_dict(state_dict: Dict[str, torch.Tensor]) -> dict:
    """Port ``Pose2Mesh`` state dict -> the JAX package's Pose2Mesh
    variables: what ``convert_pose2mesh`` gives; the inverse of
    :func:`pose2mesh_state_dict_from_flax`."""
    return _variables(state_dict, _pose2mesh_path)


def pipeline_state_dict_from_flax(variables) -> Dict[str, torch.Tensor]:
    """``{"detector": ..., "a2j": ...[, "pose2mesh": ...]}``
    (``HandNetPipeline.init``) -> port ``HandNetPipeline`` state dict
    (``detector.*``, ``a2j.*`` and, when given, ``pose2mesh.*``)."""
    out = {f"detector.{k}": v
           for k, v in fcos_state_dict_from_flax(variables["detector"]).items()}
    out.update({f"a2j.{k}": v
                for k, v in a2j_state_dict_from_flax(variables["a2j"]).items()})
    if "pose2mesh" in variables:
        out.update({f"pose2mesh.{k}": v for k, v in
                    pose2mesh_state_dict_from_flax(variables["pose2mesh"]).items()})
    return out


def load_params_npz(path: str) -> dict:
    """Rebuild a nested params dict from a flat ``.npz`` export (keys
    ``a/b/c``): a copy of ``handnet_tpu/train/checkpoints.py``
    ``load_params_npz``, whose module imports orbax."""
    data = np.load(path)
    out: dict = {}
    for key in data.files:
        parts = key.split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = data[key]
    return out
