"""JAX package variables -> port state dicts.

The inverse of ``handnet_tpu/convert/torch_weights.py`` ``convert_fcos``
(:122) and ``convert_a2j`` (:89): a ``{"params", "batch_stats"}`` tree of
numpy (or jax) arrays becomes a state dict in the reference's torch names,
which the port's modules load with ``load_state_dict(strict=True)``.
``convert_fcos(fcos_state_dict_from_flax(v))`` gives back ``v`` leaf for
leaf, and likewise for A2J.

Layout rules (reversed from the JAX package's converter):
  flax conv kernel [kh, kw, I, O] -> torch weight [O, I, kh, kw]
  norm params scale/bias          -> weight/bias
  batch_stats mean/var            -> running_mean/running_var
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Tuple

import numpy as np
import torch

_LEAF = {("params", "kernel"): "weight", ("params", "scale"): "weight",
         ("params", "bias"): "bias", ("batch_stats", "mean"): "running_mean",
         ("batch_stats", "var"): "running_var"}


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
    sub = {"downsample_conv": "downsample.0", "downsample_bn": "downsample.1"}
    return ".".join([f"layer{m.group(1)}", m.group(2)] + [sub.get(p, p) for p in rest])


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
        out = {"cls_logits": "classification_head.cls_logits",
               "hand_lr": "classification_head.hand_lr_layer",
               "bbox_reg": "regression_head.bbox_reg",
               "bbox_ctrness": "regression_head.bbox_ctrness"}
        return "head." + out[name]
    raise KeyError(f"unmapped fcos path: {'/'.join(path)}")


def _a2j_name(path: Tuple[str, ...]) -> str:
    top, *rest = path
    if top == "backbone":
        return "Backbone.model." + _resnet_name(tuple(rest))
    heads = {"classification": "classificationModel", "regression": "regressionModel",
             "depth": "DepthRegressionModel"}
    if top in heads:
        return f"{heads[top]}." + ".".join(rest)
    raise KeyError(f"unmapped a2j path: {'/'.join(path)}")


def _state_dict(variables, module_name: Callable[[Tuple[str, ...]], str]
                ) -> Dict[str, torch.Tensor]:
    out = {}
    for collection in ("params", "batch_stats"):
        for path, value in _leaves(variables.get(collection, {})):
            value = np.asarray(value)
            if path[-1] == "kernel" and value.ndim == 4:
                value = value.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            key = f"{module_name(path[:-1])}.{_LEAF[(collection, path[-1])]}"
            out[key] = torch.from_numpy(np.array(value, order="C"))
    return out


def fcos_state_dict_from_flax(variables) -> Dict[str, torch.Tensor]:
    """FCOS variables (``FCOSSystem.init``) -> port ``FCOS`` state dict."""
    return _state_dict(variables, _fcos_name)


def a2j_state_dict_from_flax(variables) -> Dict[str, torch.Tensor]:
    """A2J variables (``A2JSystem.init``) -> port ``A2J`` state dict."""
    return _state_dict(variables, _a2j_name)


def pipeline_state_dict_from_flax(variables) -> Dict[str, torch.Tensor]:
    """``{"detector": ..., "a2j": ...}`` (``HandNetPipeline.init``) -> port
    ``HandNetPipeline`` state dict (``detector.*``, ``a2j.*``)."""
    out = {f"detector.{k}": v
           for k, v in fcos_state_dict_from_flax(variables["detector"]).items()}
    out.update({f"a2j.{k}": v
                for k, v in a2j_state_dict_from_flax(variables["a2j"]).items()})
    return out
