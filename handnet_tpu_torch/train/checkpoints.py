"""Checkpoints of training: the counterpart of ``handnet_tpu/train/checkpoints.py``.

The JAX package saves its whole ``TrainState`` with orbax, which the card's
machine does not have. :class:`CheckpointManager` keeps its API and its
keep-per-epoch semantics over ``torch.save`` of ``{step, model, optimizer}``
(the model's state dict holds the running statistics, the optimizer's its
momenta), one file per epoch. :func:`save_params_npz` writes the params (or
the batch statistics) of a trainable model, FCOS, A2J, Faster R-CNN or
Pose2Mesh, under the flax tree's keys, the JAX package's
``save_params_npz`` format, so that ``handnet_tpu``'s ``load_params_npz``
reads a model trained here;
:func:`load_params_npz` reads such a file back into the nested tree.

Data parallel: a ``CheckpointManager`` given a rank's mesh writes on rank 0
only; every rank restores. ``state.model`` is the inner module, not its
``DistributedDataParallel`` wrapper, so the keys have no ``module.``
prefix and the files are those of a one-card run.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional

import numpy as np
import torch
import torch.nn as nn

from handnet_tpu_torch.convert.from_flax import (_leaves, a2j_variables_from_state_dict,
                                                 faster_rcnn_variables_from_state_dict,
                                                 fcos_variables_from_state_dict, load_params_npz,
                                                 pose2mesh_variables_from_state_dict)
from handnet_tpu_torch.models.a2j import A2J
from handnet_tpu_torch.models.faster_rcnn import FasterRCNNFPN
from handnet_tpu_torch.models.fcos import FCOS
from handnet_tpu_torch.models.pose2mesh import Pose2Mesh

__all__ = ["CheckpointManager", "save_params_npz", "load_params_npz"]


class CheckpointManager:
    """``save(epoch, state, extra)``, ``latest_epoch()``, ``restore(state,
    epoch)``; ``max_to_keep`` keeps the newest epochs only, as orbax's
    ``CheckpointManagerOptions(max_to_keep=...)`` does. Under a ``mesh``
    only rank 0 writes (and makes the directory)."""

    def __init__(self, directory: str, max_to_keep: Optional[int] = None, mesh=None):
        self.directory = os.path.abspath(directory)
        self.writes = mesh is None or mesh.is_main
        if self.writes:
            os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"{epoch}.pt")

    def epochs(self) -> List[int]:
        """The saved epochs, oldest first."""
        if not os.path.isdir(self.directory):
            return []
        found = (re.fullmatch(r"(\d+)\.pt", name) for name in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def save(self, epoch: int, state, extra: Optional[dict] = None) -> None:
        if not self.writes:
            return
        payload = {"step": state.step, "model": state.model.state_dict(),
                   "optimizer": state.optimizer.state_dict()}
        if extra:
            payload["extra"] = extra
        path = self._path(epoch)
        torch.save(payload, path + ".tmp")
        os.replace(path + ".tmp", path)   # a cut save leaves the last whole file
        if self.max_to_keep is not None:
            for old in self.epochs()[:-self.max_to_keep]:
                os.remove(self._path(old))

    def latest_epoch(self) -> Optional[int]:
        epochs = self.epochs()
        return epochs[-1] if epochs else None

    def restore(self, state, epoch: Optional[int] = None):
        """Load epoch ``epoch`` (None: the latest) into ``state``'s model and
        optimizer, on the model's device, and its step; returns ``state``."""
        if epoch is None:
            epoch = self.latest_epoch()
        if epoch is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        device = next(state.model.parameters()).device
        payload = torch.load(self._path(epoch), map_location=device, weights_only=True)
        state.model.load_state_dict(payload["model"])
        state.optimizer.load_state_dict(payload["optimizer"])
        state.step = payload["step"]
        return state


_VARIABLES = ((FCOS, fcos_variables_from_state_dict), (A2J, a2j_variables_from_state_dict),
              (FasterRCNNFPN, faster_rcnn_variables_from_state_dict),
              (Pose2Mesh, pose2mesh_variables_from_state_dict))


def save_params_npz(path: str, model: nn.Module, collection: str = "params") -> None:
    """A port FCOS, A2J, Faster R-CNN or Pose2Mesh model's ``collection`` of the flax tree
    (``"params"``, or ``"batch_stats"``: the running statistics) as a flat
    npz (keys ``backbone/conv1/kernel``, ...), as the JAX package's
    ``save_params_npz(path, tree)`` writes ``state.params`` and
    ``state.batch_stats`` (apps/train_a2j.py:146-149)."""
    for cls, variables_of in _VARIABLES:
        if isinstance(model, cls):
            tree = variables_of(model.state_dict())[collection]
            np.savez(path, **{"/".join(p): v for p, v in _leaves(tree)})
            return
    raise TypeError(f"save_params_npz: {type(model).__name__} is not a trainable model of "
                    "the port (FCOS, A2J, Faster R-CNN or Pose2Mesh)")
