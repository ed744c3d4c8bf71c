"""Serving artifacts: the fused pipeline exported per batch bucket.

Counterpart of ``handnet_tpu/export.py``. The whole frame -> joints forward
(wire dequantization, resize, detect, NMS, crop, pose) is traced once per
serving batch bucket with ``torch.export`` and written to disk beside the
weights and a manifest. A serving host loads it with
:meth:`ServingArtifact.load`, which imports the kernels' op registrations
(``ops/cuda_*.py``) and ``graphs.py`` but no model code
(``handnet_tpu_torch.models`` is never imported).

Layout::

    <dir>/manifest.json      format and torch version, device type, config,
                             frame geometry, buckets, wire, output fields,
                             the int8 layers, the mesh head
    <dir>/weights.npz        the pipeline's state dict under its torch names
                             (bfloat16 stored as float32, see the manifest's
                             ``weights_dtypes``)
    <dir>/graphs/b<N>.pt2    one ``torch.export`` program per bucket

The programs take the state dict as a call argument
(``torch.func.functional_call``), as the JAX package's graphs take their
variables, so refreshing the weights rewrites only ``weights.npz``. The
pipeline's non-persistent buffers are constants of each program: the anchor
tables, the normalization constants and, with the mesh head, the graph
pyramid's Laplacians, residual resize matrices and vertex order (they come
from the mesh's faces, not from a checkpoint). As in the JAX package's
export, a mesh head is built on the strip stand-in's pyramid. An
int8 config's programs also take each int8 layer's quantized weight and
scales (``nn.quant.given_weights``), which the loader computes once from
the float weights, as the live layers cache them: no call of a program
quantizes a weight. The kernels are recorded in the programs as the
``handnet_torch::*`` ops.

A program is exported for one device type (the card, or the CPU) and
records that device; the loader refuses another. On the card each bucket's
program is replayed as a CUDA graph (:class:`~handnet_tpu_torch.graphs.BucketGraphs`).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from handnet_tpu_torch.config import HandNetConfig, load_config
from handnet_tpu_torch.graphs import BucketGraphs, dequantize_wire, wire_dtypes, zeros
from handnet_tpu_torch.nn.quant import QuantConv, given_weights, quantize_weight

MANIFEST_NAME = "manifest.json"
WEIGHTS_NAME = "weights.npz"
GRAPH_DIR = "graphs"
FORMAT_VERSION = 2

# npz round-trips only dtypes numpy itself owns; anything else (bfloat16)
# is stored as float32 and cast back on load via the manifest's dtype map
# (a copy of ``handnet_tpu/export.py``'s set).
_NPZ_SAFE = {"float32", "float64", "float16", "int8", "int16", "int32",
             "int64", "uint8", "uint16", "uint32", "uint64", "bool"}


def _save_weights(path: str, state_dict: Dict[str, torch.Tensor]) -> Dict[str, str]:
    """Write the state dict; return ``{key: dtype name}`` for the tensors
    that had to be widened for npz."""
    dtype_map: Dict[str, str] = {}
    out: Dict[str, np.ndarray] = {}
    for key, value in state_dict.items():
        value = value.detach().cpu()
        name = str(value.dtype).removeprefix("torch.")
        if name not in _NPZ_SAFE:
            dtype_map[key] = name
            value = value.float()
        out[key] = value.numpy()
    # uncompressed: float weights are nearly incompressible
    np.savez(path, **out)
    return dtype_map


def _load_weights(path: str, dtype_map: Dict[str, str],
                  device: torch.device | str = "cpu") -> Dict[str, torch.Tensor]:
    state = {}
    with np.load(path) as data:
        for key in data.files:
            value = torch.from_numpy(data[key])
            if key in dtype_map:
                value = value.to(getattr(torch, dtype_map[key]))
            state[key] = value.to(device)
    return state


QuantWeights = Dict[str, Tuple[torch.Tensor, torch.Tensor]]


def _quantize_weights(state: Dict[str, torch.Tensor], layers: Iterable[str]) -> QuantWeights:
    """``{layer: (wq, sw)}`` of the int8 layers, from their float weights."""
    return {name: quantize_weight(state[f"{name}.weight"]) for name in layers}


class _ExportedForward(nn.Module):
    """What a bucket's program computes: wire frames (and ``paras``), the
    state dict and the int8 layers' quantized weights in, the pipeline's
    outputs (``fields``, or all) out."""

    def __init__(self, pipeline: nn.Module, fields: Optional[Tuple[str, ...]]):
        super().__init__()
        # held outside the module tree: its weights are call arguments, never
        # part of the program (its non-persistent buffers, the anchor tables
        # and normalization constants, become constants of the program)
        self._pipeline = (pipeline,)
        self._fields = fields

    def forward(self, state: Dict[str, torch.Tensor], qweights: QuantWeights,
                images: torch.Tensor, depth: torch.Tensor,
                paras: Optional[torch.Tensor] = None):
        images, depth = dequantize_wire(images, depth)
        pipeline = self._pipeline[0]
        with given_weights(pipeline, qweights):
            out = torch.func.functional_call(pipeline, state, (images, depth, paras))
        return out if self._fields is None else {k: v for k, v in out.items()
                                                 if k in self._fields}


def export_pipeline(cfg: HandNetConfig, state_dict: Dict[str, torch.Tensor], out_dir: str,
                    buckets: Sequence[int] = (1, 8, 32, 128),
                    frame_hw: Tuple[int, int] = (480, 640),
                    dtype: torch.dtype = torch.bfloat16,
                    with_xyz: bool = False,
                    quantized_wire: bool = False,
                    out_fields: Optional[Iterable[str]] = None,
                    device: Optional[torch.device | str] = None) -> str:
    """Export the fused pipeline to an artifact directory.

    Args:
      cfg: pipeline config (geometry and architecture go into the programs).
      state_dict: a ``HandNetPipeline`` state dict; a static-int8 config's
        must be calibrated (its ``act_amax`` buffers set).
      buckets: batch sizes to export, as ``PipelineServer``'s batch ladder;
        the loader routes each request to the smallest bucket that fits.
      frame_hw: input frame geometry.
      dtype: compute dtype of the convolutions.
      with_xyz: the programs also take ``paras [B, 4]`` intrinsics and emit
        camera-frame joints.
      quantized_wire: the programs take uint8 RGB and uint16 mm depth and
        dequantize on the device (``PipelineServer``'s wire format).
      out_fields: restrict the output dict (e.g. drop the ``[B, 176, 176, 1]``
        crops from the readback); None keeps everything.
      device: where the programs run: None (the card) or ``"cpu"``.

    Returns ``out_dir``.
    """
    from handnet_tpu_torch.models.pipeline import HandNetPipeline
    from handnet_tpu_torch.nn.quant import assert_calibrated

    buckets = tuple(sorted(set(int(b) for b in buckets)))
    if not buckets or buckets[0] < 1:
        raise ValueError(f"buckets must be >= 1, got {buckets}")
    pipe = HandNetPipeline(cfg, dtype=dtype, device=device)
    pipe.load_state_dict(state_dict)
    if pipe.needs_calibration():
        assert_calibrated(pipe)
    state = dict(pipe.state_dict())  # a plain dict, the loader's container
    device = next(iter(state.values())).device
    qweights = _quantize_weights(state, [name for name, m in pipe.named_modules()
                                         if isinstance(m, QuantConv)])
    fields = tuple(out_fields) if out_fields is not None else None
    forward = _ExportedForward(pipe, fields)

    height, width = frame_hw
    im_dt, d_dt = wire_dtypes(quantized_wire)
    os.makedirs(os.path.join(out_dir, GRAPH_DIR), exist_ok=True)
    for bucket in buckets:
        args = [state, qweights, zeros((bucket, height, width, 3), im_dt, device),
                zeros((bucket, height, width), d_dt, device)]
        if with_xyz:
            args.append(torch.ones((bucket, 4), dtype=torch.float32, device=device))
        program = torch.export.export(forward, tuple(args))
        # the example inputs hold all the weights: not part of the artifact
        program.example_inputs = None
        torch.export.save(program, os.path.join(out_dir, GRAPH_DIR, f"b{bucket}.pt2"))

    dtype_map = _save_weights(os.path.join(out_dir, WEIGHTS_NAME), state)
    manifest = {
        "format_version": FORMAT_VERSION,
        "torch_version": torch.__version__,
        "device_type": device.type,
        "config": dataclasses.asdict(cfg),
        "frame_hw": [height, width],
        "buckets": list(buckets),
        "compute_dtype": str(dtype).removeprefix("torch."),
        "with_xyz": bool(with_xyz),
        "quantized_wire": bool(quantized_wire),
        "out_fields": list(fields) if fields is not None else None,
        "weights_dtypes": dtype_map,
        "quantized_layers": list(qweights),  # the order of the programs' input spec
        "with_mesh": bool(cfg.pipeline.with_mesh),
    }
    with open(os.path.join(out_dir, MANIFEST_NAME), "w") as f:
        json.dump(manifest, f, indent=2)
    return out_dir


def read_manifest(path: str) -> Dict[str, Any]:
    """An artifact's manifest; raises on a format this loader does not read."""
    with open(os.path.join(path, MANIFEST_NAME)) as f:
        manifest = json.load(f)
    if manifest["format_version"] != FORMAT_VERSION:
        raise ValueError(f"artifact format {manifest['format_version']} != "
                         f"supported {FORMAT_VERSION}")
    return manifest


class ServingArtifact:
    """An exported pipeline, loaded and run without model code.

    ``predict`` accepts any batch size: requests larger than the top bucket
    are chunked through it; each chunk (and the remainder) routes to the
    smallest exported bucket that fits, padded rows sliced back off, as
    ``PipelineServer`` routes live. ``graphs`` runs the programs (a CUDA
    graph per bucket on the card).
    """

    def __init__(self, manifest: Dict[str, Any], state: Dict[str, torch.Tensor],
                 programs: Dict[int, Any], device: torch.device):
        self.manifest = manifest
        self.state = state
        self.qweights = _quantize_weights(state, manifest["quantized_layers"])
        self._programs = programs  # bucket -> the loaded program's module
        self.buckets = tuple(sorted(programs))
        self.frame_hw = tuple(manifest["frame_hw"])
        self.with_xyz = manifest["with_xyz"]
        self.with_mesh = manifest.get("with_mesh", False)
        self.quantized_wire = manifest["quantized_wire"]
        self.device = device
        self.graphs = BucketGraphs(self._forward, self.frame_hw, self.quantized_wire, device,
                                   with_paras=self.with_xyz)

    def _forward(self, images: torch.Tensor, depth: torch.Tensor, *paras: torch.Tensor):
        return self._programs[images.shape[0]](self.state, self.qweights, images, depth,
                                               *paras)

    @classmethod
    def load(cls, path: str, device: Optional[torch.device | str] = None) -> "ServingArtifact":
        """Load an artifact onto ``device``: None is the device type it was
        exported for; another type raises."""
        # the ops the programs call: importing the modules registers them
        from handnet_tpu_torch.ops import cuda_a2j, cuda_gn, cuda_int8_conv  # noqa: F401

        manifest = read_manifest(path)
        exported_for = manifest["device_type"]
        device = torch.device(exported_for if device is None else device)
        if device.type != exported_for:
            raise ValueError(f"artifact exported for {exported_for}, asked to load on "
                             f"{device.type}: export it again for that device")
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("artifact exported for the card: no CUDA device here "
                               "(torch.cuda.is_available() is False)")
        state = _load_weights(os.path.join(path, WEIGHTS_NAME),
                              manifest.get("weights_dtypes", {}), device)
        programs = {int(bucket): torch.export.load(
                        os.path.join(path, GRAPH_DIR, f"b{bucket}.pt2")).module()
                    for bucket in manifest["buckets"]}
        return cls(manifest, state, programs, device)

    def config(self) -> HandNetConfig:
        """The ``HandNetConfig`` the artifact was exported with."""
        return load_config(overrides=self.manifest["config"])

    def _bucket_for(self, n: int) -> int:
        for bucket in self.buckets:
            if bucket >= n:
                return bucket
        return self.buckets[-1]

    def _run_chunk(self, rgb: np.ndarray, depth: np.ndarray,
                   paras: Optional[np.ndarray]) -> Dict[str, np.ndarray]:
        n = rgb.shape[0]
        bucket = self._bucket_for(n)
        pad = bucket - n
        if pad:
            # explicit shapes: zeros_like(rgb[:pad]) would under-pad when pad > n
            rgb = np.concatenate([rgb, np.zeros((pad, *rgb.shape[1:]), rgb.dtype)], axis=0)
            depth = np.concatenate([depth, np.zeros((pad, *depth.shape[1:]), depth.dtype)],
                                   axis=0)
            if paras is not None:
                paras = np.concatenate([paras, np.ones((pad, *paras.shape[1:]), paras.dtype)],
                                       axis=0)
        if self.with_xyz and paras is None:
            raise ValueError("artifact exported with_xyz=True: predict requires paras [B,4]")
        out = self.graphs.run(bucket, torch.from_numpy(rgb), torch.from_numpy(depth),
                              torch.from_numpy(paras) if self.with_xyz else None)
        return {k: v[:n].cpu().numpy() for k, v in out.items()}

    def predict(self, rgb: np.ndarray, depth: np.ndarray,
                paras: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
        """Frames in, pipeline outputs out (``HandNetPipeline.forward``'s,
        or the exported fields)."""
        rgb = np.asarray(rgb)
        depth = np.asarray(depth)
        if paras is not None:
            paras = np.asarray(paras, np.float32)
        if rgb.ndim != 4 or rgb.shape[1:3] != self.frame_hw:
            raise ValueError(f"rgb must be [B, {self.frame_hw[0]}, {self.frame_hw[1]}, 3], "
                             f"got {rgb.shape}")
        want_im, want_d = (np.uint8, np.uint16) if self.quantized_wire else (np.float32,) * 2
        rgb = np.ascontiguousarray(rgb, dtype=want_im)
        depth = np.ascontiguousarray(depth, dtype=want_d)
        top = self.buckets[-1]
        chunks = [self._run_chunk(rgb[s:s + top], depth[s:s + top],
                                  paras[s:s + top] if paras is not None else None)
                  for s in range(0, rgb.shape[0], top)]
        if len(chunks) == 1:
            return chunks[0]
        return {k: np.concatenate([c[k] for c in chunks], axis=0) for k in chunks[0]}
