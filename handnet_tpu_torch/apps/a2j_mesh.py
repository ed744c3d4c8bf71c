"""Mesh inference demo: depth crops -> A2J joints -> Pose2Mesh MANO mesh.

The port's ``handnet_tpu/apps/a2j_mesh.py``. Reference: a2j_mesh.py:20-94
(A2J over the DexYCB test loader -> clip UVD -> convert_joints ->
Pose2Mesh -> mesh post-transform ``mesh*1000 + root; y,z *= -1``
(:77-80); rendering via pyrender stays host-side and optional).

Each sample runs ``A2JSystem.predict`` alone (batch 1), which on the card
decodes through kernel K1, one launch per sample; the mesh head is the
demo's (``apps/demo.build_mesh_head``). ``--device``: the card by default,
which raises where there is none. Without ``--a2j-checkpoint`` the A2J
weights are the port's seeded random init (seed 0).

Usage:
  python -m handnet_tpu_torch.apps.a2j_mesh --data-dir DIR [--synthetic N]
      [--a2j-checkpoint ...] [--out meshes.npz] [--limit 8] [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from handnet_tpu_torch.config import A2JConfig
from handnet_tpu_torch.convert.torch_weights import a2j_state_dict, load_torch_checkpoint
from handnet_tpu_torch.data.a2j_data import A2JDataSource, A2JSampleConfig
from handnet_tpu_torch.data.dexycb import DexYCBDataset, refine_indices
from handnet_tpu_torch.models.a2j import A2JSystem
from handnet_tpu_torch.ops.geometry import convert_joints
from handnet_tpu_torch.train.trainer import resolve_device


@torch.no_grad()
def main(argv=None) -> dict:
    """Write the npz (``sample{i}_joints_xyz``, ``sample{i}_mesh``) and
    return its arrays."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--data-dir", default=os.environ.get("DEX_YCB_DIR"))
    parser.add_argument("--synthetic", type=int, default=0)
    parser.add_argument("--a2j-checkpoint", default=None)
    parser.add_argument("--crop", type=int, default=176)
    parser.add_argument("--limit", type=int, default=8)
    parser.add_argument("--out", default="meshes.npz")
    parser.add_argument("--device", default=None,
                        help="torch device to run on (default: the card)")
    args = parser.parse_args(argv)
    device = resolve_device("a2j_mesh", args.device)

    if args.synthetic:
        import tempfile

        from handnet_tpu_torch.data.synthetic import make_synthetic_dexycb

        root = args.data_dir or tempfile.mkdtemp(prefix="synth_dexycb_")
        if not os.path.exists(os.path.join(root, "calibration")):
            make_synthetic_dexycb(root, n_sequences=args.synthetic, n_frames=4)
        ds = DexYCBDataset("s0", "train", data_dir=root)
    else:
        ds = DexYCBDataset("s0", "test", data_dir=args.data_dir)
    src = A2JDataSource(ds, refine_indices(ds)[:args.limit], augment=False,
                        cfg=A2JSampleConfig(crop_w=args.crop,
                                            crop_h=args.crop))

    cfg = A2JConfig(crop_h=args.crop, crop_w=args.crop,
                    transposed_anchors=bool(args.a2j_checkpoint))
    system = A2JSystem(cfg)
    if args.a2j_checkpoint:
        system.load_state_dict(a2j_state_dict(load_torch_checkpoint(args.a2j_checkpoint)))
    else:
        print("WARNING: random A2J weights")
        system.init_weights_(torch.Generator().manual_seed(0))
    system = system.to(device, memory_format=torch.channels_last).eval()

    from handnet_tpu_torch.apps.demo import build_mesh_head

    mesh_head, _mesh_faces = build_mesh_head(device=device)

    results = {}
    for i in range(len(src)):
        sample = src[i]
        uvd = system.predict(torch.from_numpy(sample["depth"][None]).to(device))
        # clip UVD to the crop (a2j_mesh.py:60-62)
        uvd = torch.clamp(uvd, 0, args.crop - 1)
        xyz = convert_joints(uvd, torch.from_numpy(sample["box"][None]).to(device),
                             torch.from_numpy(sample["paras"][None]).to(device),
                             args.crop, args.crop)
        xyz = xyz.cpu().numpy()[0]
        uv_full = uvd[0].cpu().numpy()[:, :2]
        mesh = mesh_head(uv_full)
        # reference post-transform: to camera mm + flip y,z (a2j_mesh.py:77-80)
        root = xyz[0]
        mesh_cam = mesh * 1000.0 + root
        mesh_cam[:, 1:] *= -1
        results[f"sample{i}_joints_xyz"] = xyz
        results[f"sample{i}_mesh"] = mesh_cam
    np.savez(args.out, **results)
    print(f"wrote {args.out} ({len(results) // 2} meshes)")
    return results


if __name__ == "__main__":
    main()
