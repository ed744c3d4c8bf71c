"""Pose2Mesh training: 2D joints -> MANO mesh, with the reference's loss
bundle (coord L1 + normal + edge).

Counterpart of ``handnet_tpu/apps/train_pose2mesh.py``, whose batch maker
and step are closures inside ``main``; here they are module functions
(:func:`make_batch`, :func:`train_step`). Supervision comes from
MANO-generated (verts, joints) pairs: the licensed assets converted to npz
(``--mano-npz``), or synthetic assets and poses for smoke runs. Everything
is drawn from one ``np.random.default_rng(0)`` in the JAX app's order (the
synthetic assets, then per step the pose, then the betas), so both apps see
the same poses.

As in the JAX app the model trains in eval mode (``apply(train=False)``):
its BatchNorms keep their initial statistics and only their scale and bias
learn, and there is no dropout. The optimizer is ``optax.adam(lr)``: Adam
with betas (0.9, 0.999), eps 1e-8, no weight decay. The step runs in
float32; TF32 stays as torch leaves it (off for matmuls), and the run
prints the setting.

The joint graph has the 16 horizontal ``HORI`` pairs as extra edges, as the
JAX app's has; the serving pipeline's pyramid is built without them.

Usage:
  python -m handnet_tpu_torch.apps.train_pose2mesh --synthetic --steps 50 [--device cpu]
  python -m handnet_tpu_torch.apps.train_pose2mesh --mano-npz mano_right.npz ...
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from handnet_tpu_torch.config import Pose2MeshConfig
from handnet_tpu_torch.models.mano import ManoAssets, ManoLayer
from handnet_tpu_torch.models.pose2mesh import Pose2Mesh
from handnet_tpu_torch.ops.graph import (HAND_SKELETON, GraphPyramid, build_graph_pyramid,
                                         strip_faces)
from handnet_tpu_torch.train.checkpoints import save_params_npz
from handnet_tpu_torch.train.pose2mesh_loss import pose2mesh_losses
from handnet_tpu_torch.train.trainer import TrainState, resolve_device

# the joint graph's horizontal edges between neighbouring fingers, beside
# the skeleton (the JAX app's SKELETON is the pipeline's HAND_SKELETON)
HORI = ((1, 5), (5, 9), (9, 13), (13, 17), (2, 6), (6, 10), (10, 14),
        (14, 18), (3, 7), (7, 11), (11, 15), (15, 19), (4, 8), (8, 12),
        (12, 16), (16, 20))


def load_assets(mano_npz: Optional[str], synthetic: bool,
                rng: np.random.Generator) -> ManoAssets:
    """The MANO assets from ``mano_npz``, else synthetic ones drawn from
    ``rng``."""
    if mano_npz:
        return ManoAssets.load(mano_npz)
    if not synthetic:
        print("no --mano-npz given; falling back to --synthetic assets")
    return ManoAssets.synthetic(rng)


def training_faces(assets: ManoAssets) -> np.ndarray:
    """The assets' faces, or the 778-vertex strip where they are the
    synthetic placeholder (all zeros)."""
    faces = assets.faces
    if faces.size == 0 or faces.max() == 0:
        faces = strip_faces()
    return faces


def build_pyramid(faces: np.ndarray, num_joints: int = 21) -> GraphPyramid:
    """The mesh pyramid with the skeleton and ``HORI`` joint graph, 6 levels."""
    return build_graph_pyramid(faces, num_joints, HAND_SKELETON, HORI, levels=6)


def make_batch(rng: np.random.Generator, layer: ManoLayer, batch: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One batch on ``layer``'s device: a pose ``[B, 48]`` and betas ``[B,
    10]``, each standard normal times 0.3, through MANO; the input is the
    joints' orthographic (x, y), minus their mean over the joints, over
    their population std over (joints, xy) plus 1e-6. Returns ``(pose2d [B,
    21, 2], verts [B, 778, 3], joints [B, 21, 3])``, millimetres."""
    pose = rng.normal(size=(batch, 48)).astype(np.float32) * 0.3
    betas = rng.normal(size=(batch, 10)).astype(np.float32) * 0.3
    device = layer.v_template.device
    verts, joints = layer(torch.from_numpy(pose).to(device), torch.from_numpy(betas).to(device))
    j2d = joints[:, :, :2]
    j2d = (j2d - j2d.mean(dim=1, keepdim=True)) / (
        j2d.std(dim=(1, 2), correction=0, keepdim=True) + 1e-6)
    return j2d, verts, joints


def train_step(state: TrainState, order: torch.Tensor, faces: torch.Tensor,
               pose2d: torch.Tensor, verts_gt: torch.Tensor, joints_gt: torch.Tensor
               ) -> Dict[str, torch.Tensor]:
    """One Adam update of ``state.model`` (a ``Pose2Mesh`` in eval mode) on
    the losses of its mesh, taken in vertex order (``order`` = the
    pyramid's ``perm_reverse[:V]``), and of its lifted pose. Returns the
    losses, detached."""
    mesh, pose3d = state.model.eval()(pose2d)
    losses = pose2mesh_losses(mesh[:, order], verts_gt, pose3d, joints_gt, faces=faces)
    state.update(losses["total_loss"])
    return {k: v.detach() for k, v in losses.items()}


def init_state(pyramid: GraphPyramid, lr: float, device: torch.device,
               cfg: Pose2MeshConfig = Pose2MeshConfig(), seed: int = 0) -> TrainState:
    """A float32 Pose2Mesh with seeded random weights on ``device`` and its
    Adam at a constant ``lr``."""
    model = Pose2Mesh(pyramid, cfg)
    model.init_weights_(torch.Generator().manual_seed(seed))
    model.to(device)
    optimizer = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    return TrainState(0, model, optimizer, lambda count: lr)


def main(argv=None) -> dict:
    """Train for ``--steps`` steps and write ``<output>/params.npz`` in the
    flax keys. Returns the per-step losses, the host clock after each step
    (``step_end_s``, from the loop's start; each step ends in reading its
    loss), the npz's path and the trained ``state``."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--mano-npz", default=None,
                        help="converted MANO assets (the JAX package's convert/mano_assets.py)")
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--output", default="models/pose2mesh_tpu")
    parser.add_argument("--device", default=None,
                        help="torch device to train on (default: the card)")
    args = parser.parse_args(argv)
    device = resolve_device("train_pose2mesh", args.device)

    rng = np.random.default_rng(0)
    assets = load_assets(args.mano_npz, args.synthetic, rng)
    layer = ManoLayer(assets, flat_hand_mean=True, device=device)
    faces = training_faces(assets)
    pyramid = build_pyramid(faces)
    state = init_state(pyramid, args.lr, device)
    order = torch.from_numpy(pyramid.perm_reverse[:faces.max() + 1]).to(device)
    faces_t = torch.from_numpy(np.asarray(faces, np.int64)).to(device)
    print(f"training on {device}, float32, TF32 matmul "
          f"{'on' if torch.backends.cuda.matmul.allow_tf32 else 'off'}")

    os.makedirs(args.output, exist_ok=True)
    history, step_end_s = [], []
    t0 = time.perf_counter()
    for step in range(args.steps):
        losses = train_step(state, order, faces_t, *make_batch(rng, layer, args.batch))
        history.append({k: float(v) for k, v in losses.items()})
        step_end_s.append(time.perf_counter() - t0)
        if step % max(args.steps // 10, 1) == 0:
            last = history[-1]
            print(f"step {step}: total={last['total_loss']:.4f} "
                  f"mesh={last['mesh_coord']:.4f} edge={last['edge']:.4f}")
    print(f"done in {time.perf_counter() - t0:.1f}s; loss {history[0]['total_loss']:.4f} -> "
          f"{history[-1]['total_loss']:.4f}")

    path = os.path.join(args.output, "params.npz")
    save_params_npz(path, state.model)
    print(f"saved {path}")
    return {"losses": history, "step_end_s": step_end_s, "params_npz": path, "state": state}


if __name__ == "__main__":
    main()
