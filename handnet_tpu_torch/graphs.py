"""One CUDA graph per batch bucket, and the serving wire format.

The JAX package compiles one XLA executable per batch bucket
(``handnet_tpu/apps/serve.py:275-281``), so a dispatch is one call and the
host can assemble batch N+1 while the device computes batch N. The port's
eager forward launches several hundred kernels from Python per call; its
counterpart of the per-bucket executable is a CUDA graph captured per
bucket: :class:`BucketGraphs`, shared by the server (``apps/serve.py``) and
the deployment artifact (``export.py``).

For each bucket it keeps static input buffers in the wire dtypes, warms the
forward up on its own stream (cuDNN picks its algorithms, and the K1/K2s
arrival counters of ``kernels/scratch.py`` are allocated for that stream),
captures one call, and then serves :meth:`BucketGraphs.run` by copying the
inputs in, replaying, and copying the asked-for outputs out into fresh
tensors, all on that stream. Facts the capture relies on:

* K3g encodes its TMA tensor maps on the host with the addresses of its
  operands (``csrc/int8_conv.cu``), so a replay reads the captured buffers:
  inputs always go through the static buffers, never new tensors;
* the last block of a K1/K2s launch sets its arrival counter back to zero
  (``csrc/split_done.cuh``), so replays need no clearing;
* the forward builds no device tensor from host data (``models/fcos.py``,
  ``models/pipeline.py``, ``ops/resize.py``), which a capture would refuse;
* the kernels' launch counters move while the warm-up and the capture call
  the wrappers, not on replay.

On the CPU there are no graphs: :meth:`BucketGraphs.run` calls the forward.
:class:`MeshGraphs` runs one :class:`BucketGraphs` per device of a
one-process data mesh, each on its block of the bucket.
On the card a failed capture raises; nothing falls back to eager serving.

The wire format is the JAX server's (``handnet_tpu/apps/serve.py:117-120``):
uint8 RGB and uint16 depth in millimetres, widened on the device by
:func:`dequantize_wire`.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch

# eager calls on the capture stream before each capture
WARMUP_CALLS = 3

# float32(1 / 255) and float32(1 / 1000): XLA compiles the JAX server's
# division by these constants as a multiply by their reciprocals
_INV_255 = 1.0 / 255.0
_INV_1000 = 1.0 / 1000.0


def wire_dtypes(quantized: bool) -> Tuple[torch.dtype, torch.dtype]:
    """(RGB dtype, depth dtype) of frames on the wire."""
    return (torch.uint8, torch.uint16) if quantized else (torch.float32, torch.float32)


def dequantize_wire(images: torch.Tensor, depth: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """uint8 RGB -> float32 0-1 and uint16 millimetres -> float32 metres;
    float32 frames pass through. torch's uint16 supports few operations, so
    the depth is reinterpreted as int16 and widened to int32 first."""
    if images.dtype == torch.uint8:
        images = images.float() * _INV_255
    if depth.dtype == torch.uint16:
        depth = (depth.view(torch.int16).to(torch.int32) & 0xFFFF).float() * _INV_1000
    return images, depth


def zeros(shape: Tuple[int, ...], dtype: torch.dtype,
          device: torch.device | str = "cpu", pin_memory: bool = False) -> torch.Tensor:
    """``torch.zeros``, also for uint16, which has no fill kernel on the
    card: it is zeroed as int16 and viewed as uint16."""
    fill = torch.int16 if dtype == torch.uint16 else dtype
    out = torch.zeros(shape, dtype=fill, device=device, pin_memory=pin_memory)
    return out.view(dtype)


Forward = Callable[..., Dict[str, torch.Tensor]]


class BucketGraphs:
    """A forward over frames, captured once per batch bucket on the card.

    Args:
      forward: ``forward(images, depth)`` or, with ``with_paras``,
        ``forward(images, depth, paras)`` -> dict of tensors; it is called
        with wire-dtype tensors of the bucket's batch.
      frame_hw: (H, W) of every frame.
      quantized_wire: frames are uint8 RGB and uint16 depth (else float32).
      device: where the forward runs. On a CUDA device every bucket is a
        CUDA graph; on the CPU the forward is called as it is.
      with_paras: the forward takes ``paras [B, 4]`` float32 too.
    """

    def __init__(self, forward: Forward, frame_hw: Tuple[int, int], quantized_wire: bool,
                 device: torch.device | str, with_paras: bool = False):
        self.forward = forward
        self.frame_hw = tuple(frame_hw)
        self.wire = wire_dtypes(quantized_wire)
        self.device = torch.device(device)
        self.with_paras = with_paras
        # held from a capture or a copy in to the copy out
        self._lock = threading.Lock()
        # bucket -> (graph, static inputs, static outputs)
        self._graphs: Dict[int, Tuple[torch.cuda.CUDAGraph, tuple, dict]] = {}
        if self.device.type == "cuda":
            if self.device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())
            self.stream = torch.cuda.Stream(self.device)
            # one memory pool for every bucket: replays never overlap (one
            # stream), and each replay's outputs are copied out before the next
            self._pool = torch.cuda.graph_pool_handle()

    @property
    def captured(self) -> Tuple[int, ...]:
        return tuple(sorted(self._graphs))

    def _static_inputs(self, bucket: int) -> tuple:
        h, w = self.frame_hw
        im_dt, d_dt = self.wire
        inputs = [zeros((bucket, h, w, 3), im_dt, self.device),
                  zeros((bucket, h, w), d_dt, self.device)]
        if self.with_paras:
            inputs.append(torch.ones((bucket, 4), dtype=torch.float32, device=self.device))
        return tuple(inputs)

    def capture(self, bucket: int) -> None:
        """Warm the forward up on this object's stream and capture one call
        of batch ``bucket`` (a no-op on the CPU, or for a captured bucket)."""
        with self._lock:
            self._capture(bucket)

    def _capture(self, bucket: int) -> None:
        if self.device.type != "cuda" or bucket in self._graphs:
            return
        inputs = self._static_inputs(bucket)
        with torch.cuda.device(self.device):
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(self.stream):
                for _ in range(WARMUP_CALLS):
                    self.forward(*inputs)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self._pool, stream=self.stream):
                outputs = self.forward(*inputs)
        self._graphs[bucket] = (graph, inputs, outputs)

    def run(self, bucket: int, images: torch.Tensor, depth: torch.Tensor,
            paras: Optional[torch.Tensor] = None,
            fields: Optional[Iterable[str]] = None) -> Dict[str, torch.Tensor]:
        """The forward's outputs (those in ``fields``, or all) for a batch of
        exactly ``bucket`` frames in the wire dtypes, on this object's
        device. On the card the inputs (device or pinned host tensors) are
        copied into the bucket's static buffers and the graph is replayed
        (captured first if it was not); the outputs are fresh tensors, which
        the caller's stream may use at once."""
        if images.shape[0] != bucket or depth.shape[0] != bucket:
            raise ValueError(f"bucket {bucket}: got batches of {images.shape[0]} and "
                             f"{depth.shape[0]} frames")
        if self.with_paras and paras is None:
            raise ValueError("this forward takes paras [B, 4]")
        args = (images, depth, paras) if self.with_paras else (images, depth)
        with self._lock:
            if self.device.type != "cuda":
                out = self.forward(*args)
                return {k: v for k, v in out.items() if fields is None or k in fields}
            self._capture(bucket)
            graph, inputs, outputs = self._graphs[bucket]
            caller = torch.cuda.current_stream(self.device)
            self.stream.wait_stream(caller)
            with torch.cuda.stream(self.stream):
                for static, arg in zip(inputs, args):
                    static.copy_(arg, non_blocking=True)
                graph.replay()
                out = {k: v.clone() for k, v in outputs.items()
                       if fields is None or k in fields}
            caller.wait_stream(self.stream)
        for t in out.values():
            t.record_stream(caller)
        return out


class MeshGraphs:
    """:class:`BucketGraphs` over the devices of a one-process data mesh
    (``parallel.create_mesh``), the JAX server's bucket sharded over
    ``mesh.size`` devices: one forward (a pipeline replica) and one set of
    graphs per device. A bucket of B frames runs as ``mesh.size``
    contiguous blocks of ``B / mesh.size``, block i on device i, whose
    outputs are concatenated in order on the first device. A bucket that
    does not divide raises ``ValueError``.

    K3g's tensor maps are encoded per launch and the kernels' arrival
    counters are kept per (device, stream) (``kernels/scratch.py``), so
    the devices' graphs share nothing.
    """

    def __init__(self, forwards, frame_hw: Tuple[int, int], quantized_wire: bool, devices):
        self.parts = [BucketGraphs(f, frame_hw, quantized_wire, d)
                      for f, d in zip(forwards, devices)]
        self.device = self.parts[0].device

    def _block(self, bucket: int) -> int:
        """Frames per device of a bucket."""
        if bucket % len(self.parts):
            raise ValueError(f"bucket {bucket} does not divide over {len(self.parts)} devices")
        return bucket // len(self.parts)

    def capture(self, bucket: int) -> None:
        k = self._block(bucket)
        for part in self.parts:
            part.capture(k)

    def run(self, bucket: int, images: torch.Tensor, depth: torch.Tensor,
            fields: Optional[Iterable[str]] = None) -> Dict[str, torch.Tensor]:
        """:meth:`BucketGraphs.run` of each block on its device (each queued
        before the next, so the devices compute together), the outputs
        concatenated on the first device."""
        k = self._block(bucket)
        outs = [part.run(k, images[i * k:(i + 1) * k], depth[i * k:(i + 1) * k], fields=fields)
                for i, part in enumerate(self.parts)]
        return {key: torch.cat([o[key].to(self.device) for o in outs]) for key in outs[0]}
