"""Multi-stream streaming server around the fused pipeline.

Counterpart of ``handnet_tpu/apps/serve.py``, the productionized form of
the reference's ROS node (ros_demo.py:170-246): frames from any number of
streams come in on a host queue, are MICROBATCHED into fixed-batch forwards
(a partial batch is padded to the smallest batch bucket that holds it),
TWO batches stay in flight (the host assembles batch N+1 while the card
computes batch N), and results fan back out per (stream_id, frame_id) on
an output queue.

On the card each bucket's forward is one CUDA graph, captured by
:meth:`PipelineServer.compile` (``graphs.py``): a dispatch is a copy into
the graph's static buffers and one replay, not several hundred kernel
launches from Python. Frames travel in the wire format, uint8 RGB and
uint16 mm depth, through two pinned host staging buffers used in turn and
``non_blocking`` copies, and are widened on the card.

With a ``mesh`` (``parallel.create_mesh``: the cards of this process, the
JAX server's ``mesh=``) every bucket is sharded over the cards: one
pipeline replica and one CUDA graph per bucket block on each card
(``graphs.MeshGraphs``), the blocks concatenated in order.

Run the built-in throughput check (synthetic frames, host-thread fed):

    python -m handnet_tpu_torch.apps.serve --frames 512 --batch 128 [--mesh N]
"""

from __future__ import annotations

import argparse
import queue
import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from handnet_tpu_torch.config import HandNetConfig, load_config, pipeline_outputs
from handnet_tpu_torch.graphs import BucketGraphs, MeshGraphs, dequantize_wire, wire_dtypes, zeros
from handnet_tpu_torch.parallel.mesh import DataMesh, replicate

_STOP = object()
DEFAULT_FIELDS = ("joints_uvd", "boxes", "found", "scores")


def _check_fields(out_fields: Iterable[str], available: Iterable[str], source: str) -> None:
    missing = sorted(set(out_fields) - set(available))
    if missing:
        raise ValueError(f"{source} does not emit {missing} (it emits {list(available)})")


def _wire_forward(pipe):
    """A replica's forward on wire frames."""
    def forward(images: torch.Tensor, depth: torch.Tensor):
        return pipe(*dequantize_wire(images, depth))
    return forward


def _check_mesh(mesh: DataMesh, device, batch_size: int, batch_buckets) -> None:
    """A server's mesh: one process's devices, every bucket dividing over
    them (``handnet_tpu/apps/serve.py:97-104``)."""
    if not isinstance(mesh, DataMesh):
        raise TypeError(f"PipelineServer: mesh is a parallel.DataMesh, not {type(mesh).__name__}")
    if mesh.world_size != 1:
        raise ValueError("PipelineServer: a mesh of one process's devices (create_mesh), not a "
                         "rank of a process group")
    if device is not None:
        raise ValueError("PipelineServer: the mesh names the devices; pass device=None")
    bad = [b for b in sorted(set(batch_buckets or ()) | {batch_size}) if b % mesh.size]
    if bad:
        raise ValueError(f"batch buckets {bad} must divide over mesh size {mesh.size}")


class PipelineServer:
    """Queue-in/queue-out serving wrapper over one pipeline.

    Args:
      cfg: HandNetConfig (detector/a2j/pipeline operating point).
      batch_size: the top batch bucket; also the microbatch target.
      state_dict: ``HandNetPipeline`` weights; the seeded init (seed 0) when
        None.
      frame_hw: static (H, W) every submitted frame must match.
      flush_timeout: seconds to wait for more frames before dispatching a
        partial batch (latency/throughput knob).
      out_fields: which pipeline outputs to return per frame; a field the
        pipeline does not produce is refused here (``"verts"`` needs a
        ``pipeline.with_mesh`` config; the server passes no intrinsics, so
        no ``*_xyz``).
      dtype: compute dtype of the convolutions.
      quantized_transfer: ship frames as uint8 RGB and uint16 mm depth
        (5 bytes a pixel to the card instead of float32's 16), widened there.
      mesh: a one-process ``parallel.DataMesh`` (``create_mesh(n)``): every
        bucket is sharded over its ``mesh.size`` devices, one pipeline
        replica each, and must divide over them (``ValueError``). None is
        one device.
      batch_buckets: optional batch-size ladder, e.g. ``(1, 8, 32)``. A
        collected microbatch of n frames is padded only to the SMALLEST
        bucket >= n (``batch_size`` is always the top rung), so a 1-frame
        trickle runs the batch-1 graph. One CUDA graph per bucket, captured
        in :meth:`compile`.
      device: where the pipeline runs: None (the card; raises without one)
        or ``"cpu"``, where every dispatch runs the forward eagerly. Under a
        mesh, the mesh's devices (``device`` must be None).
    """

    def __init__(self, cfg: Optional[HandNetConfig] = None,
                 batch_size: int = 32, state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 frame_hw: Tuple[int, int] = (480, 640),
                 flush_timeout: float = 0.002,
                 out_fields: Iterable[str] = DEFAULT_FIELDS,
                 dtype: torch.dtype = torch.bfloat16,
                 quantized_transfer: bool = True,
                 mesh: Optional[DataMesh] = None,
                 batch_buckets: Optional[Iterable[int]] = None,
                 device: Optional[torch.device | str] = None):
        from handnet_tpu_torch.models.pipeline import HandNetPipeline

        _check_fields(out_fields, pipeline_outputs(cfg or HandNetConfig()), "the pipeline")
        if mesh is not None:
            _check_mesh(mesh, device, batch_size, batch_buckets)
            device = mesh.device
        self.pipe = HandNetPipeline(cfg, dtype=dtype, device=device)
        if state_dict is not None:
            self.pipe.load_state_dict(state_dict)
        if mesh is None:
            self.replicas = [self.pipe]
            graphs = BucketGraphs(self._pipeline_forward, frame_hw, quantized_transfer,
                                  next(self.pipe.parameters()).device)
        else:
            self.replicas = replicate(mesh, self.pipe)
            graphs = MeshGraphs([_wire_forward(p) for p in self.replicas], frame_hw,
                                quantized_transfer, mesh.devices)
        self._setup(self.pipe.cfg, batch_size, frame_hw, flush_timeout, out_fields,
                    quantized_transfer, batch_buckets, graphs)

    def _setup(self, cfg: HandNetConfig, batch_size: int, frame_hw: Tuple[int, int],
               flush_timeout: float, out_fields: Iterable[str], quantized_transfer: bool,
               batch_buckets: Optional[Iterable[int]], graphs: BucketGraphs) -> None:
        self.cfg = cfg
        self.batch_size = batch_size
        buckets = sorted(set(batch_buckets or ()) | {batch_size})
        if buckets[-1] != batch_size or buckets[0] < 1:
            raise ValueError(f"batch_buckets {buckets} must lie in [1, batch_size="
                             f"{batch_size}]")
        self.batch_buckets = tuple(buckets)
        # dispatches per bucket: routing observability
        self.bucket_dispatches: Dict[int, int] = {b: 0 for b in buckets}
        self.frame_hw = tuple(frame_hw)
        self.flush_timeout = flush_timeout
        self.out_fields = tuple(out_fields)
        self.quantized_transfer = quantized_transfer
        self.graphs = graphs
        self.device = graphs.device
        # two host staging buffers of the top bucket, used in turn (pinned on
        # the card, so the copies run without the host): rows [0, filled) hold
        # an earlier batch's frames, rows past it are zero; ``copied`` is an
        # event after the buffer's last copy to the card
        h, w = self.frame_hw
        im_dt, d_dt = wire_dtypes(quantized_transfer)
        pin = self.device.type == "cuda"
        self._staging = [(zeros((batch_size, h, w, 3), im_dt, pin_memory=pin),
                          zeros((batch_size, h, w), d_dt, pin_memory=pin)) for _ in range(2)]
        self._filled = [0, 0]
        self._copied: list = [None, None]
        self._turn = 0
        self.inputs: "queue.Queue" = queue.Queue(maxsize=4 * batch_size)
        self.results: "queue.Queue" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._frames_done = 0
        self._served_seconds = 0.0
        self._loop_start: Optional[float] = None
        # submit->result wall time of the last 10k frames
        self._latencies: deque = deque(maxlen=10_000)
        # frames that came back as {"error": ...} instead of results
        self.error_count = 0

    def _pipeline_forward(self, images: torch.Tensor, depth: torch.Tensor):
        return self.pipe(*dequantize_wire(images, depth))

    def _sync_replicas(self) -> None:
        """The first replica's state (a calibration) into the others."""
        for replica in self.replicas[1:]:
            replica.load_state_dict(self.pipe.state_dict())

    @classmethod
    def from_artifact(cls, path, out_fields: Optional[Iterable[str]] = None,
                      flush_timeout: float = 0.002, mesh: Optional[Any] = None,
                      device: Optional[torch.device | str] = None) -> "PipelineServer":
        """A server that runs an exported artifact (``handnet_tpu_torch.export``)
        instead of the model: the batch ladder, wire format, geometry and
        weights come from its manifest, and each dispatch runs the bucket's
        loaded program (a CUDA graph on the card); model code is never
        imported. ``path`` is the artifact's directory, loaded onto
        ``device`` (``ServingArtifact.load``), or an artifact loaded
        already, whose graphs the server then shares. ``mesh`` is refused
        with ``ValueError``, as the JAX package's export refuses one."""
        from handnet_tpu_torch.export import ServingArtifact, read_manifest

        if mesh is not None:
            raise ValueError("artifact serving is single-device; shard by running one "
                             "server per card")
        loaded = path if isinstance(path, ServingArtifact) else None
        manifest = loaded.manifest if loaded else read_manifest(path)
        if manifest["with_xyz"]:
            raise ValueError("server wire has no intrinsics: export the serving artifact "
                             "with with_xyz=False")
        exported_fields = manifest.get("out_fields")
        if out_fields is None:
            out_fields = tuple(exported_fields) if exported_fields else DEFAULT_FIELDS
        _check_fields(out_fields, exported_fields or pipeline_outputs(
            load_config(overrides=manifest["config"])), "the artifact")
        art = loaded or ServingArtifact.load(path, device=device)
        server = cls.__new__(cls)
        server.pipe = None
        server.replicas = []
        server._setup(art.config(), art.buckets[-1], art.frame_hw, flush_timeout, out_fields,
                      art.quantized_wire, art.buckets, art.graphs)
        return server

    # -- client side --------------------------------------------------------

    def submit(self, stream_id, frame_id, rgb: np.ndarray, depth: np.ndarray) -> None:
        """rgb [H, W, 3]: float 0-1 or uint8. depth [H, W]: float meters or
        uint16 millimeters (sensor-native formats pass through unconverted
        when quantized_transfer is on)."""
        if rgb.shape[:2] != self.frame_hw or depth.shape[:2] != self.frame_hw:
            raise ValueError(f"frame rgb {rgb.shape[:2]} / depth {depth.shape[:2]} != "
                             f"static {self.frame_hw}")
        if self.quantized_transfer:
            if rgb.dtype != np.uint8:
                rgb = np.clip(rgb * 255.0, 0, 255).astype(np.uint8)
            if depth.dtype != np.uint16:
                depth = np.clip(depth * 1000.0, 0, 65535).astype(np.uint16)
        else:
            if rgb.dtype == np.uint8:
                rgb = rgb.astype(np.float32) / 255.0
            if depth.dtype == np.uint16:
                depth = depth.astype(np.float32) / 1000.0
        self.inputs.put((stream_id, frame_id, rgb, depth, time.perf_counter()))

    def get(self, timeout: Optional[float] = None):
        """Next finished frame: (stream_id, frame_id, {field: np.ndarray}).
        If that frame's batch failed, the dict is instead {"error":
        "<repr>"}: the server stays up and keeps serving (``error_count``
        tallies these)."""
        return self.results.get(timeout=timeout)

    # -- lifecycle -----------------------------------------------------------

    def calibrate(self, images: np.ndarray, depth: np.ndarray) -> None:
        """One-pass static-int8 activation-scale calibration
        (``HandNetPipeline.calibrate``) on representative frames; call
        before :meth:`start`. ``images`` float [B,H,W,3] in 0-1, ``depth``
        float [B,H,W] meters. A no-op for float and dynamic-int8 configs."""
        self.pipe.calibrate(torch.as_tensor(images, dtype=torch.float32, device=self.device),
                            torch.as_tensor(depth, dtype=torch.float32, device=self.device))
        self._sync_replicas()

    def load_calibration(self, path: str) -> None:
        """Load a saved static-int8 calibration (``nn.quant.save_calibration``,
        or the JAX package's file) into this server's pipeline."""
        from handnet_tpu_torch.nn.quant import load_calibration
        load_calibration(path, self.pipe)
        self._sync_replicas()

    def start(self) -> "PipelineServer":
        # fail loudly if a quant="static" model was never calibrated:
        # uncalibrated static scales saturate every activation to +-127 and
        # serve finite garbage (a no-op for float and dynamic configs; an
        # artifact was checked when it was exported)
        if self.pipe is not None:
            from handnet_tpu_torch.nn.quant import assert_calibrated
            for replica in self.replicas:
                assert_calibrated(replica)
        self.compile()
        self._stop.clear()
        self._thread = threading.Thread(target=self._serve_loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Graceful stop: already-queued frames are still served. An Event,
        not a queue sentinel: a sentinel put() can deadlock against
        producers on the bounded input queue."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def compile(self) -> None:
        """Capture every bucket's CUDA graph (nothing to do on the CPU)."""
        for bucket in self.batch_buckets:
            self.graphs.capture(bucket)

    @property
    def sustained_fps(self) -> float:
        return (self._frames_done / self._served_seconds
                if self._served_seconds else 0.0)

    def latency_stats(self) -> Dict[str, float]:
        """Submit->result wall-time percentiles (ms) over the last <=10k
        served frames: {"count", "p50_ms", "p90_ms", "p99_ms", "max_ms"}.
        Per-frame latency includes queueing, the microbatch flush wait and
        the forward: the client-visible number, not the kernel time."""
        lat = np.asarray(self._latencies, np.float64)
        if lat.size == 0:
            return {"count": 0, "p50_ms": 0.0, "p90_ms": 0.0, "p99_ms": 0.0, "max_ms": 0.0}
        p50, p90, p99 = np.percentile(lat, [50, 90, 99]) * 1e3
        return {"count": int(lat.size), "p50_ms": float(p50), "p90_ms": float(p90),
                "p99_ms": float(p99), "max_ms": float(lat.max() * 1e3)}

    def _mark(self):
        """An event after the work enqueued so far (None on the CPU, where
        the work is done when the call returns)."""
        if self.device.type != "cuda":
            return None
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return event

    def compute_fps_probe(self, n_batches: int = 16, inflight: int = 2) -> float:
        """Sustained fps of the top bucket's forward with frames PRE-STAGED
        on the device: the compute ceiling of this server, with the
        host-transfer and microbatch-assembly terms excluded. The queue-fed
        ``sustained_fps`` divided by this number is the serving overhead."""
        h, w = self.frame_hw
        im_dt, d_dt = wire_dtypes(self.quantized_transfer)
        bsz = self.batch_size
        images = zeros((bsz, h, w, 3), im_dt, self.device)
        depth = zeros((bsz, h, w), d_dt, self.device)
        self._fwd(images, depth)     # captures the graph on the card
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        pending: deque = deque()
        t0 = time.perf_counter()
        for _ in range(n_batches):
            self._fwd(images, depth)
            pending.append(self._mark())
            if len(pending) >= inflight:
                done = pending.popleft()
                if done is not None:
                    done.synchronize()
        for done in pending:
            if done is not None:
                done.synchronize()
        return n_batches * bsz / (time.perf_counter() - t0)

    # -- server side ---------------------------------------------------------

    def _fwd(self, images: torch.Tensor, depth: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One bucket's forward on wire frames: the out_fields, on the device."""
        return self.graphs.run(images.shape[0], images, depth, fields=self.out_fields)

    def _collect_batch(self, block: bool):
        """Gather up to batch_size frames (flush-timeout bounded): the
        microbatcher. ``block=False`` (work already in flight) returns None
        at once on an empty queue, so that in-flight results drain instead
        of waiting for input. Returns _STOP once the stop event is set AND
        the queue is drained."""
        try:
            item = (self.inputs.get(timeout=0.05) if block
                    else self.inputs.get(block=False))
        except queue.Empty:
            if self._stop.is_set() and self.inputs.empty():
                return _STOP
            return None
        items = [item]
        deadline = time.perf_counter() + self.flush_timeout
        while len(items) < self.batch_size:
            remain = deadline - time.perf_counter()
            try:
                items.append(self.inputs.get(timeout=max(remain, 0.0)))
            except queue.Empty:
                break
        return items

    def _dispatch(self, items):
        n = len(items)
        # smallest bucket that fits: partial microbatches pay for their own
        # size, not for batch_size - n frames of padding
        bucket = next(b for b in self.batch_buckets if b >= n)
        self.bucket_dispatches[bucket] += 1
        turn, self._turn = self._turn, self._turn ^ 1
        if self._copied[turn] is not None:
            self._copied[turn].synchronize()   # its last batch has left the buffer
        images, depth = self._staging[turn]
        im_np, d_np = images.numpy(), depth.numpy()
        for i, (_, _, rgb, dep, _) in enumerate(items):
            im_np[i] = rgb
            d_np[i] = dep
        if self._filled[turn] > n:   # padding rows are zeros
            im_np[n:self._filled[turn]] = 0
            d_np[n:self._filled[turn]] = 0
        self._filled[turn] = n
        out = self._fwd(images[:bucket], depth[:bucket])
        self._copied[turn] = self._mark()
        meta = [(sid, fid, ts) for sid, fid, _, _, ts in items]
        return out, meta, n

    def _complete(self, inflight) -> None:
        out, meta, n = inflight
        host = {k: v.cpu().numpy() for k, v in out.items()}  # waits for the batch
        done = time.perf_counter()
        for i, (sid, fid, ts) in enumerate(meta):
            self._latencies.append(done - ts)
            self.results.put((sid, fid, {k: v[i] for k, v in host.items()}))
        self._frames_done += n
        if self._loop_start is not None:
            self._served_seconds = time.perf_counter() - self._loop_start

    def _fail(self, meta, exc: BaseException) -> None:
        """Deliver a per-frame error result instead of dropping frames: a
        failed batch must never leave clients blocked in :meth:`get` or
        kill the serve thread (errors surface at dispatch or at the
        completion readback)."""
        self.error_count += len(meta)
        for sid, fid, ts in meta:
            self._latencies.append(time.perf_counter() - ts)
            self.results.put((sid, fid, {"error": repr(exc)}))

    def _safe_complete(self, inflight) -> None:
        try:
            self._complete(inflight)
        except Exception as e:          # readback failed -> error results
            self._fail(inflight[1], e)

    def _serve_loop(self) -> None:
        inflight: deque = deque()
        t0 = time.perf_counter()
        self._loop_start = t0
        while True:
            # only block on input when nothing is in flight; otherwise an
            # idle input queue must drain results, not starve them
            items = self._collect_batch(block=not inflight)
            if items is _STOP:
                break
            if items is None:           # input idle -> flush oldest batch
                if inflight:
                    self._safe_complete(inflight.popleft())
                continue
            try:
                inflight.append(self._dispatch(items))
            except Exception as e:      # dispatch failed -> error results
                self._fail([(s, f, ts) for s, f, _, _, ts in items], e)
                continue
            if len(inflight) >= 2:      # double buffer: drain the older one
                self._safe_complete(inflight.popleft())
        while inflight:
            self._safe_complete(inflight.popleft())
        self._served_seconds = time.perf_counter() - t0


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--frames", type=int, default=512)
    parser.add_argument("--batch", type=int, default=128)
    parser.add_argument("--streams", type=int, default=4)
    parser.add_argument("--profile", default="fast",
                        help="operating point: config.PROFILES (fast, quant_static, quant, "
                             "parity, turbo)")
    parser.add_argument("--quant", default=None, choices=("1", "static"),
                        help="compose int8 convs onto the profile: 1 = dynamic scales, "
                             "static = calibrated (bench.py's QUANT)")
    parser.add_argument("--compute-only", action="store_true",
                        help="also print the device-staged compute ceiling "
                             "(no host transfer) for overhead attribution")
    parser.add_argument("--buckets", default=None,
                        help="comma-separated batch-bucket ladder (e.g. "
                             "'1,8,32'); partial microbatches pad only to "
                             "the smallest fitting bucket")
    parser.add_argument("--calib", default=None,
                        help="static-int8 calibration file (.npz): loaded if it "
                             "exists, else written after calibrating on the warm-up "
                             "frames (only used by static-int8 profiles)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    parser.add_argument("--mesh", type=int, default=0,
                        help="shard every bucket over N devices of this process (N cards, or "
                             "N CPU replicas with --device cpu); 0: one device")
    args = parser.parse_args(argv)

    import os

    from handnet_tpu_torch.config import resolve_config
    from handnet_tpu_torch.nn.quant import npz_path, save_calibration

    cfg = resolve_config(args.profile, quant={"1": True}.get(args.quant, args.quant))
    buckets = ([int(b) for b in args.buckets.split(",")] if args.buckets else None)
    mesh = None
    if args.mesh:
        from handnet_tpu_torch.parallel.mesh import create_mesh
        mesh = create_mesh(args.mesh, device=args.device or "cuda")
    server = PipelineServer(cfg, batch_size=args.batch, batch_buckets=buckets,
                            device=None if mesh else args.device, mesh=mesh)

    rng = np.random.default_rng(0)
    # sensor-native frames: no per-frame float->uint8 conversion on submit
    frames = [(rng.integers(0, 256, size=(480, 640, 3), dtype=np.uint8),
               rng.integers(300, 1000, size=(480, 640), dtype=np.uint16))
              for _ in range(8)]

    if server.pipe.needs_calibration():
        if args.calib and os.path.exists(npz_path(args.calib)):
            server.load_calibration(args.calib)
        else:
            server.calibrate(np.stack([f[0] for f in frames]).astype(np.float32) / 255.0,
                             np.stack([f[1] for f in frames]).astype(np.float32) / 1000.0)
            if args.calib:
                save_calibration(args.calib, server.pipe)

    if args.compute_only:
        ceiling = server.compute_fps_probe(n_batches=max(args.frames // args.batch, 4))
        print(f"compute ceiling (device-staged, no transfer): {ceiling:.1f} fps")
    server.start()

    def feeder(sid):
        for fid in range(args.frames // args.streams):
            rgb, dep = frames[(sid + fid) % len(frames)]
            server.submit(sid, fid, rgb, dep)

    threads = [threading.Thread(target=feeder, args=(s,)) for s in range(args.streams)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    got = 0
    want = args.streams * (args.frames // args.streams)
    while got < want:
        server.get()
        got += 1
    dt = time.perf_counter() - t0
    for t in threads:
        t.join()
    server.stop()
    print(f"served {got} frames from {args.streams} host streams: "
          f"{got / dt:.1f} fps sustained")
    stats = server.latency_stats()
    print(f"per-frame latency (submit->result): p50 {stats['p50_ms']:.1f} "
          f"p90 {stats['p90_ms']:.1f} p99 {stats['p99_ms']:.1f} ms")
    if len(server.batch_buckets) > 1:
        print(f"bucket dispatches: {server.bucket_dispatches}")


if __name__ == "__main__":
    main()
