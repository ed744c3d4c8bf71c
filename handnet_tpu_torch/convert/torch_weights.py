"""Reference torch checkpoints -> the port's state dicts.

The port's modules carry the reference's torch names, so a reference
checkpoint needs no key map, only unwrapping. :func:`load_torch_checkpoint`
unwraps as ``handnet_tpu/convert/torch_weights.py:316-329`` does (a
``model_state_dict`` entry, then ``model``, then a Lightning
``state_dict`` whose ``a2j.`` prefix is dropped) and keeps the tensors;
:func:`a2j_state_dict` keeps the entries that the port's ``A2J`` holds,
leaving out what ``convert_a2j`` leaves out (the backbone's unused ``fc``
classifier, the ``criterion.``/``post_process.`` buffers and BatchNorm's
``num_batches_tracked``); :func:`fcos_state_dict` does the same for a
reference FCOS, and :func:`faster_rcnn_state_dict` for a reference Faster
R-CNN (the counterpart of ``handnet_tpu/convert/torch_weights.py:180-253``
``convert_faster_rcnn``).
"""

from __future__ import annotations

import re
from typing import Dict

import torch


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A .pth/.ckpt as a flat state dict of CPU tensors, detached."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "model_state_dict" in ckpt:
        ckpt = ckpt["model_state_dict"]  # pose2mesh .pth.tar (ros_demo.py:144)
    if isinstance(ckpt, dict) and "model" in ckpt:
        ckpt = ckpt["model"]
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = {k.replace("a2j.", "", 1) if k.startswith("a2j.") else k: v
                for k, v in ckpt["state_dict"].items()}
    return {k: v.detach() for k, v in ckpt.items() if isinstance(v, torch.Tensor)}


def a2j_state_dict(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A reference A2JModel state dict, as the port's ``A2J`` loads it with
    ``load_state_dict(strict=True)``."""
    return {k: v for k, v in state_dict.items()
            if not (k.startswith(("Backbone.model.fc.", "criterion.", "post_process."))
                    or k.endswith(".num_batches_tracked"))}


# torchvision's newer FPN names: inner_blocks.{i}.0.* -> inner_blocks.{i}.*
_FPN_BLOCK = (r"^backbone\.fpn\.(inner|layer)_blocks\.(\d+)\.0\.", r"backbone.fpn.\1_blocks.\2.")


def fcos_state_dict(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A reference FCOS state dict, as the port's ``FCOS`` loads it with
    ``load_state_dict(strict=True)``: BatchNorm's ``num_batches_tracked``
    dropped, and the FPN's ``inner_blocks.{i}.0.*``/``layer_blocks.{i}.0.*``
    (torchvision's newer names, which ``convert_fcos`` also reads) as
    ``inner_blocks.{i}.*``/``layer_blocks.{i}.*``."""
    return {re.sub(*_FPN_BLOCK, k): v
            for k, v in state_dict.items() if not k.endswith(".num_batches_tracked")}


def faster_rcnn_state_dict(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A reference FasterRCNN state dict (fpn_utils/faster_rcnn_fpn.py), as
    the port's ``FasterRCNNFPN`` loads it with ``load_state_dict(strict=True)``:
    the backbone's unused ``fc`` classifier, anchor buffers, ``transform.*``
    and ``num_batches_tracked`` dropped, as ``convert_faster_rcnn`` drops
    them; the FPN's ``.0.`` block names and the RPN head's
    ``Conv2dNormActivation`` layout (``rpn.head.conv.0.0.*``) as the plain
    names."""
    out = {}
    for k, v in state_dict.items():
        if (k.startswith(("backbone.body.fc.", "transform.")) or "anchor" in k
                or k.endswith(".num_batches_tracked")):
            continue
        k = re.sub(*_FPN_BLOCK, k)
        k = re.sub(r"^rpn\.head\.(conv|cls_logits|bbox_pred)\.0\.0\.", r"rpn.head.\1.", k)
        out[k] = v
    return out
