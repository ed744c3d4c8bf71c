"""Streaming hand-perception demo: camera-rate frames -> joints (+mesh).

The port's ``handnet_tpu/apps/demo.py``. Reference: ros_demo.py:170-398 — a
ROS node wiring RGB+depth subscribers to HandNet with pyrender mesh output.
The ROS transport is environment-specific (``apps/ros_node.py`` holds its
transport-agnostic core), so this app provides a generic ``FrameSource``
interface (folder / synthetic) feeding the SAME fused pipeline,
``models/pipeline.HandNetPipeline``, one frame per call: on the card each
frame launches kernels K2s and K2a 24 times each and K1 once.

Every flag of the JAX app is here, plus ``--device`` (the card by default,
which raises where there is none; ``--device cpu`` runs on the CPU). The
convolutions run in bf16, as the JAX app's. Without
``--fcos-checkpoint``/``--a2j-checkpoint`` the weights are the port's
seeded random init (seed 0), not the JAX app's ``PRNGKey(0)`` draw. The
steady-state fps times each frame (after the first) from the call until the
card has finished it (``torch.cuda.synchronize``), not until the launches
were queued. Frames are read through the port's ``data/image_io`` (the same
pixels as the JAX app's ``cv2.imread``), and ``--render-mesh`` overlays are
written as RGB PNGs through it.

Usage:
  python -m handnet_tpu_torch.apps.demo --source synthetic --frames 32
  python -m handnet_tpu_torch.apps.demo --source folder --input DIR  # color_*.jpg + depth_*.png
"""

from __future__ import annotations

import argparse
import glob
import os
import time
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from handnet_tpu_torch.config import A2JConfig, FCOSConfig, HandNetConfig, PipelineConfig
from handnet_tpu_torch.convert.torch_weights import (a2j_state_dict, fcos_state_dict,
                                                     load_torch_checkpoint)
from handnet_tpu_torch.data.image_io import imread_color, read_png, write_png
from handnet_tpu_torch.models.pipeline import HandNetPipeline
from handnet_tpu_torch.models.pose2mesh import Pose2Mesh, normalize_joints_for_pose2mesh
from handnet_tpu_torch.ops.geometry import convert_joints
from handnet_tpu_torch.ops.graph import HAND_SKELETON, build_graph_pyramid, strip_faces
from handnet_tpu_torch.train.trainer import resolve_device


class FrameSource:
    """Yields (rgb [H,W,3] 0-1 float32, depth [H,W] meters)."""

    def frames(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        raise NotImplementedError


class SyntheticSource(FrameSource):
    def __init__(self, n: int, h: int = 480, w: int = 640, seed: int = 0):
        self.n, self.h, self.w = n, h, w
        self.rng = np.random.default_rng(seed)

    def frames(self):
        for _ in range(self.n):
            yield (self.rng.uniform(size=(self.h, self.w, 3)).astype(np.float32),
                   self.rng.uniform(0.3, 1.2, size=(self.h, self.w))
                   .astype(np.float32))


class FolderSource(FrameSource):
    """Paired color_*.jpg / depth_*.png (mm) files, sorted."""

    def __init__(self, directory: str):
        self.colors = sorted(glob.glob(os.path.join(directory, "color_*.jpg")))
        self.depths = sorted(glob.glob(os.path.join(directory, "depth_*.png")))
        if len(self.colors) != len(self.depths):
            raise SystemExit("mismatched color/depth file counts")

    def frames(self):
        for c, d in zip(self.colors, self.depths):
            rgb = imread_color(c)[:, :, ::-1].astype(np.float32) / 255.0
            depth = read_png(d).astype(np.float32) / 1000.0
            yield rgb, depth


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--source", choices=["synthetic", "folder"],
                        default="synthetic")
    parser.add_argument("--input", default=None)
    parser.add_argument("--frames", type=int, default=32)
    parser.add_argument("--fcos-checkpoint", default=None)
    parser.add_argument("--a2j-checkpoint", default=None)
    parser.add_argument("--num-classes", type=int, default=3,
                        help="detector classes (ros_demo.py:374 default)")
    parser.add_argument("--mesh", action="store_true",
                        help="lift joints to a MANO mesh (needs pose2mesh "
                             "weights; runs with random weights otherwise)")
    parser.add_argument("--render-mesh", action="store_true",
                        help="rasterize the predicted mesh into each frame "
                             "(software z-buffer, utils/raster.py; the "
                             "ros_demo.py:51-128 pyrender overlay equivalent); "
                             "implies --mesh. Writes overlay_NNNN.png next to "
                             "--out. Without --mano-assets the surface uses a "
                             "stand-in consecutive-strip triangulation, not "
                             "MANO topology — pass the npz for a real surface")
    parser.add_argument("--mano-assets", default=None,
                        help="mano_right.npz from "
                             "handnet_tpu_torch/convert/mano_assets.py; "
                             "supplies the real MANO face topology for "
                             "--render-mesh")
    parser.add_argument("--paras", type=float, nargs=4,
                        default=[600.0, 600.0, 320.0, 240.0],
                        help="fx fy cx cy")
    parser.add_argument("--flip-left", action="store_true",
                        help="mirror frames for left-hand tracking (A2J is "
                             "right-hand trained; ros_demo.py:260-262)")
    parser.add_argument("--out", default=None, help="npz of per-frame results")
    parser.add_argument("--size", type=int, nargs=2, default=[480, 640],
                        metavar=("H", "W"), help="synthetic frame size")
    parser.add_argument("--net-size", type=int, nargs=2, default=None,
                        metavar=("H", "W"),
                        help="detector input geometry (default: the "
                             "config's min-800 parity geometry)")
    parser.add_argument("--crop", type=int, default=176,
                        help="A2J crop size (176 = reference)")
    parser.add_argument("--score-thresh", type=float, default=None)
    parser.add_argument("--device", default=None,
                        help="torch device to run on (default: the card)")
    return parser.parse_args(argv)


def build_config(args) -> HandNetConfig:
    # converted torch checkpoints need the reference anchor pairing
    # (ops/anchors.py transposed mode; a2j/a2j.py:86-89 permute quirk);
    # num_classes defaults to 3 like ros_demo.py:374 (hand = last class)
    fcos_kwargs = dict(num_classes=args.num_classes, ext=False)
    if args.net_size:
        fcos_kwargs.update(image_h=args.net_size[0],
                           image_w=args.net_size[1])
    if args.score_thresh is not None:
        fcos_kwargs["score_thresh"] = args.score_thresh
    return HandNetConfig(
        fcos=FCOSConfig(**fcos_kwargs),
        a2j=A2JConfig(transposed_anchors=bool(args.a2j_checkpoint),
                      crop_h=args.crop, crop_w=args.crop),
        pipeline=PipelineConfig(crop_size=args.crop))


def build_pipeline(args, device: torch.device, dtype: torch.dtype = torch.bfloat16,
                   use_kernels: bool = True) -> HandNetPipeline:
    """The pipeline of ``args`` (its config, its checkpoints) on ``device``
    with ``dtype`` convolutions; ``use_kernels=False`` runs the kernels'
    plain versions (to price or check them; never chosen by the app)."""
    pipe = HandNetPipeline(build_config(args), dtype=dtype, device=device,
                           use_kernels=use_kernels, seed=0)
    if args.fcos_checkpoint:
        pipe.detector.load_state_dict(fcos_state_dict(load_torch_checkpoint(
            args.fcos_checkpoint)))
    if args.a2j_checkpoint:
        pipe.a2j.load_state_dict(a2j_state_dict(load_torch_checkpoint(
            args.a2j_checkpoint)))
    return pipe.eval()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    """Run the demo. Returns the per-frame results (the npz's values),
    ``found`` (frames with a hand), ``fps`` and ``ms_per_frame`` (steady
    state: every frame after the first, each until it has finished on the
    device), ``overlay_ms`` (the host's mean time to render and write an
    overlay, or None) and ``out`` (the npz's path, or None)."""
    args = parse_args(argv)
    device = resolve_device("demo", args.device)

    source = (SyntheticSource(args.frames, h=args.size[0], w=args.size[1])
              if args.source == "synthetic" else FolderSource(args.input))
    pipe = build_pipeline(args, device)
    cfg = pipe.cfg
    paras_np = np.asarray(args.paras, np.float32)[None]
    paras = torch.from_numpy(paras_np).to(device)

    mesh_fn = mesh_faces = None
    if args.mesh or args.render_mesh:
        mesh_fn, mesh_faces = build_mesh_head(mano_assets=args.mano_assets, device=device)
    overlay_dir = None
    if args.render_mesh:
        overlay_dir = os.path.dirname(os.path.abspath(args.out or "out.npz"))
        os.makedirs(overlay_dir, exist_ok=True)

    results = []
    times = []
    overlay_times = []
    for i, (rgb, depth) in enumerate(source.frames()):
        rgb_disp = rgb  # original (un-mirrored) frame, for overlays
        if args.flip_left:
            rgb = rgb[:, ::-1].copy()
            depth = depth[:, ::-1].copy()
        im = torch.from_numpy(rgb[None]).to(device)
        d = torch.from_numpy(depth[None]).to(device)
        t0 = time.perf_counter()
        out = pipe(im, d, paras)
        _sync(device)
        if i > 0:  # skip the first frame (allocations, cuDNN's choices)
            times.append(time.perf_counter() - t0)
        host = {k: out[k][0].cpu().numpy()
                for k in ("joints_uvd", "joints_xyz", "boxes", "found", "sides")}
        frame_result = {
            "joints_uvd": host["joints_uvd"],
            "joints_xyz": host["joints_xyz"],
            "box": host["boxes"],
            "found": bool(host["found"]),
            "side": int(host["sides"]),
        }
        if args.flip_left and frame_result["found"]:
            # mirror crop box + u coordinates back to the original frame,
            # then recompute xyz from the un-mirrored geometry so the saved
            # (box, joints_uvd, joints_xyz) triple is self-consistent
            w = rgb.shape[1]
            x1, y1, x2, y2 = frame_result["box"]
            frame_result["box"] = np.array([w - 1 - x2, y1, w - 1 - x1, y2],
                                           np.float32)
            crop = cfg.pipeline.crop_size
            uvd = frame_result["joints_uvd"].copy()
            # index-convention mirror, matching the box's w-1-x above
            # (crop - u would bias the unprojected xyz by one crop pixel)
            uvd[:, 0] = (crop - 1) - uvd[:, 0]
            frame_result["joints_uvd"] = uvd
            frame_result["joints_xyz"] = convert_joints(
                torch.from_numpy(uvd[None]), torch.from_numpy(frame_result["box"][None]),
                torch.from_numpy(paras_np), crop, crop).numpy()[0]
        if mesh_fn is not None and frame_result["found"]:
            # lift in the NETWORK frame — with --flip-left the lifter sees
            # the right-hand skeleton it was trained on, not the mirrored
            # one — then mirror the root-relative verts back to the original
            # frame so mesh/box/joints stay self-consistent
            net_uv = host["joints_uvd"][:, :2]
            verts = mesh_fn(net_uv)
            if args.flip_left:
                verts = verts * np.array([-1.0, 1.0, 1.0], np.float32)
            frame_result["mesh"] = verts
            if overlay_dir is not None:
                # render onto the original frame: joints_xyz is already in
                # original-frame camera coordinates after the un-flip above
                t1 = time.perf_counter()
                _write_overlay(overlay_dir, i, rgb_disp, verts,
                               mesh_faces, frame_result["joints_xyz"],
                               args.paras)
                overlay_times.append(time.perf_counter() - t1)
        results.append(frame_result)

    found = sum(r["found"] for r in results)
    fps = 1.0 / np.mean(times) if times else 0.0
    ms = 1e3 * float(np.mean(times)) if times else None
    print(f"processed {len(results)} frames, hand found in {found}, "
          f"~{fps:.1f} fps steady-state" + (f" ({ms:.3f} ms per frame)" if ms else ""))
    if args.out:
        np.savez(args.out, **{
            f"frame{i:04d}_{k}": v for i, r in enumerate(results)
            for k, v in r.items()})
        print(f"wrote {args.out}")
    return {"results": results, "found": found, "fps": fps, "ms_per_frame": ms,
            "overlay_ms": 1e3 * float(np.mean(overlay_times)) if overlay_times else None,
            "out": args.out}


def _write_overlay(out_dir: str, idx: int, rgb: np.ndarray,
                   verts_rel: np.ndarray, faces: np.ndarray,
                   joints_xyz: np.ndarray, paras) -> None:
    """Rasterize the (root-anchored) predicted mesh into the frame and save
    it as ``overlay_NNNN.png`` — the pyrender composite of
    ros_demo.py:51-128, GL-free."""
    from handnet_tpu_torch.utils.raster import render_mesh_overlay

    fx, fy, cx, cy = paras
    k = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)
    # pose2mesh emits meter-scale root-relative verts; joints_xyz is mm
    # (ops/geometry.py). The reference does mesh*1000 + joints3d before
    # rendering (ros_demo.py:334) — same here, everything in mm.
    verts_cam = (np.asarray(verts_rel, np.float64) * 1000.0
                 + joints_xyz[0])  # anchor at the wrist joint
    frame8 = np.clip(rgb * 255.0, 0, 255).astype(np.uint8)
    overlay = render_mesh_overlay(frame8, verts_cam, faces, k)
    write_png(os.path.join(out_dir, f"overlay_{idx:04d}.png"), overlay[:, :, ::-1])


class MeshHead:
    """A Pose2Mesh lifting head on ``device``: 2D joints ``[21, 2]`` (host
    numpy) -> mesh vertices ``[778, 3]`` (root-relative metres, float32,
    host numpy), in MANO vertex order. ``model`` and ``pyramid`` are the
    network and its graph pyramid."""

    def __init__(self, model: Pose2Mesh, pyramid, device: torch.device):
        self.model, self.pyramid, self.device = model, pyramid, device
        self.order = pyramid.perm_reverse[:778]

    @torch.no_grad()
    def __call__(self, joints2d: np.ndarray) -> np.ndarray:
        norm = normalize_joints_for_pose2mesh(joints2d)
        mesh, _ = self.model(torch.from_numpy(norm[None]).to(self.device))
        return mesh[0].float().cpu().numpy()[self.order]


def build_mesh_head(mano_assets: Optional[str] = None,
                    device: Optional[torch.device | str] = "cpu"):
    """Pose2Mesh lifting head over the detected 2D joints
    (ros_demo.py:131-168 equivalent; random weights unless trained).

    Returns (run_fn, faces) — a :class:`MeshHead`, and the faces for
    downstream overlay rendering. With ``mano_assets`` (npz from
    convert/mano_assets.py), the graph pyramid and the rendered surface use
    the REAL MANO triangulation; otherwise a consecutive-strip stand-in of
    the same vertex count (fine for plumbing, degenerate as a rendered
    surface). The weights are the port's seeded init (seed 0), float32, in
    eval mode, on ``device``."""
    if mano_assets:
        faces = np.asarray(np.load(mano_assets, allow_pickle=False)["faces"],
                           np.int64)
    else:
        # stand-in 778-vert strip triangulation (same sizes as MANO)
        faces = strip_faces(778)
    pyramid = build_graph_pyramid(faces, 21, HAND_SKELETON, levels=6)
    model = Pose2Mesh(pyramid)
    model.init_weights_(torch.Generator().manual_seed(0))
    device = torch.device(device)
    return MeshHead(model.to(device).eval(), pyramid, device), faces


if __name__ == "__main__":
    main()
