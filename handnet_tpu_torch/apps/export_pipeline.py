"""Export the fused pipeline to a serving artifact (``handnet_tpu_torch.export``).

Counterpart of ``handnet_tpu/apps/export_pipeline.py``:

    python -m handnet_tpu_torch.apps.export_pipeline --out DIR
        [--profile quant_static] [--quant 1|static] [--buckets 1,8,32,128]
        [--hw 480,640] [--checkpoint DIR] [--calib scales.npz]
        [--quantized-wire] [--fields joints_uvd,boxes,found,scores] [--xyz]
        [--serve-check] [--device cpu]

``--checkpoint`` reads the ``{detector,a2j[,pose2mesh]}/params.npz`` +
``batch_stats.npz`` trees that the JAX package's
``train.checkpoints.save_params_npz`` writes and converts them
(``convert/from_flax.py``); without it the artifact carries seeded random
weights (for plumbing and latency tests only). The artifact is exported for
the card unless ``--device cpu`` asks for the CPU.

The profiles have no mesh head, and neither this CLI nor the JAX package's
has a switch for it: a ``pipeline.with_mesh`` artifact is exported from
Python (``export.export_pipeline`` with that config; :func:`_load_checkpoint`
loads a ``pose2mesh/`` component into its pipeline).
"""

import argparse
import os

import numpy as np


def _load_checkpoint(pipe, base: str) -> None:
    """Load the flax trees under ``base`` into ``pipe``: ``detector/`` and
    ``a2j/``, and ``pose2mesh/`` where it exists (a pipeline without the
    mesh head skips it, as the JAX package's pipeline ignores it). A
    static-int8 config's ``act_amax`` buffers are not in a checkpoint:
    ``--calib`` sets them."""
    from handnet_tpu_torch.convert.from_flax import (load_params_npz,
                                                     pipeline_state_dict_from_flax)

    variables = {}
    for component in ("detector", "a2j", "pose2mesh"):
        cdir = os.path.join(base, component)
        if component == "pose2mesh" and (pipe.pose2mesh is None or not os.path.isdir(cdir)):
            continue
        if not os.path.isdir(cdir):
            raise SystemExit(f"no {component}/ under {base}")
        tree = {"params": load_params_npz(os.path.join(cdir, "params.npz"))}
        stats = os.path.join(cdir, "batch_stats.npz")
        if os.path.exists(stats):
            tree["batch_stats"] = load_params_npz(stats)
        variables[component] = tree
    missing, unexpected = pipe.load_state_dict(pipeline_state_dict_from_flax(variables),
                                               strict=False)
    missing = [k for k in missing if not k.endswith(".act_amax")]
    if missing or unexpected:
        raise SystemExit(f"checkpoint does not fit the profile: missing {missing[:3]}, "
                         f"unexpected {unexpected[:3]}")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", required=True)
    parser.add_argument("--profile", default="quant_static",
                        help="operating point: config.PROFILES")
    parser.add_argument("--quant", default=None, choices=("1", "static"),
                        help="compose int8 convs onto the profile (bench.py's QUANT)")
    parser.add_argument("--buckets", default="1,8,32,128")
    parser.add_argument("--hw", default="480,640", help="frame geometry H,W")
    parser.add_argument("--checkpoint", default=None,
                        help="dir of per-component params.npz trees")
    parser.add_argument("--calib", default=None,
                        help="static-int8 calibration .npz (nn.quant.save_calibration, "
                             "or the JAX package's): required for static-int8 profiles")
    parser.add_argument("--quantized-wire", action="store_true",
                        help="programs take uint8 RGB / uint16 mm depth "
                             "(PipelineServer's wire format)")
    parser.add_argument("--fields", default=None,
                        help="comma-separated output subset (drops e.g. the large crops "
                             "tensor from the readback)")
    parser.add_argument("--xyz", action="store_true",
                        help="programs also take paras [B,4] and emit camera-frame joints")
    parser.add_argument("--serve-check", action="store_true",
                        help="reload the artifact and run one batch through every bucket "
                             "before exiting")
    parser.add_argument("--device", default=None,
                        help="torch device to export for (default: the card)")
    args = parser.parse_args(argv)

    import torch

    from handnet_tpu_torch.config import resolve_config
    from handnet_tpu_torch.export import ServingArtifact, export_pipeline
    from handnet_tpu_torch.models.pipeline import HandNetPipeline
    from handnet_tpu_torch.nn.quant import load_calibration

    cfg = resolve_config(args.profile, quant={"1": True}.get(args.quant, args.quant))
    height, width = (int(v) for v in args.hw.split(","))
    buckets = tuple(int(b) for b in args.buckets.split(","))

    pipe = HandNetPipeline(cfg, dtype=torch.bfloat16, device=args.device)
    if args.checkpoint:
        _load_checkpoint(pipe, args.checkpoint.rstrip("/"))
    else:
        print("WARNING: no --checkpoint: exporting random weights")
    if pipe.needs_calibration():
        if not args.calib:
            raise SystemExit(f"profile {args.profile} is static-int8: pass --calib "
                             "(nn.quant.save_calibration writes one)")
        load_calibration(args.calib, pipe)

    out = export_pipeline(
        cfg, pipe.state_dict(), args.out, buckets=buckets, frame_hw=(height, width),
        dtype=torch.bfloat16, with_xyz=args.xyz, quantized_wire=args.quantized_wire,
        out_fields=(args.fields.split(",") if args.fields else None), device=args.device)
    total = sum(os.path.getsize(os.path.join(root, f))
                for root, _, files in os.walk(out) for f in files)
    print(f"exported {args.profile} -> {out} (buckets {buckets}, {total / 1e6:.1f} MB)")

    if args.serve_check:
        art = ServingArtifact.load(out, device=args.device)
        rng = np.random.default_rng(0)
        for bucket in art.buckets:
            rgb = rng.uniform(0, 255, (bucket, height, width, 3))
            depth = rng.uniform(300, 1000, (bucket, height, width))
            if not art.quantized_wire:
                rgb, depth = rgb / 255.0, depth / 1000.0
            paras = (np.tile([600.0, 600.0, width / 2, height / 2], (bucket, 1))
                     if art.with_xyz else None)
            got = art.predict(rgb, depth, paras)
            finite = all(np.isfinite(v).all() for v in got.values()
                         if np.issubdtype(np.asarray(v).dtype, np.floating))
            print(f"  bucket {bucket}: keys={sorted(got)} finite={finite}")


if __name__ == "__main__":
    main()
