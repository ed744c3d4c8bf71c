"""Optional ROS adapter: RGB+depth topics -> PipelineServer -> result topics.

Reference: ros_demo.py:170-246 — a rospy node with two image subscribers
paired by ``message_filters.ApproximateTimeSynchronizer`` (queue 1, slop
0.1 s, :204-207), intrinsics pulled once from CameraInfo (:198-202), depth
decoded from 16UC1 (mm) or 32FC1 (m) (:224-236), and per-frame results
published back out.

The port's copy of ``handnet_tpu/apps/ros_node.py``. It keeps the
pairing/intrinsics/decode semantics in transport-agnostic pure Python
(testable without ROS) and plugs them into the port's
:class:`~handnet_tpu_torch.apps.serve.PipelineServer` (microbatched, two
batches in flight, one CUDA graph per bucket on the card) instead of the
reference's frame-at-a-time ``run_network`` loop; ``joints_xyz`` comes from
the port's ``ops/geometry.convert_joints``. The actual ROS 2 transport
(``rclpy``) is imported lazily inside :func:`run_rclpy`; the module imports
fine without ROS installed. No machine this repository is tested on has
ROS, so :func:`run_rclpy` has run nowhere; ``chip_smoke.py``'s
``[demo_apps]`` phase drives :class:`HandNetRosNode` over a server on the
card with a fake transport.

Usage on a ROS 2 machine (the server builds on the card unless
``--device cpu``)::

    python -m handnet_tpu_torch.apps.ros_node --rgb /head_camera/rgb/image_raw \
        --depth /head_camera/depth/image_raw \
        --camera-info /head_camera/depth/camera_info
"""

from __future__ import annotations

import argparse
import threading
from collections import deque
from typing import Callable, Deque, Optional, Tuple

import numpy as np


class ApproximateTimeSynchronizer:
    """Pair messages from two channels whose stamps differ <= ``slop``.

    The message_filters.ApproximateTimeSynchronizer(queue_size, slop)
    equivalent used at ros_demo.py:204-207, with the same greedy semantics:
    on arrival, match against the closest-stamp message in the other
    channel's queue; unmatched messages wait in a bounded deque (oldest
    dropped — a live stream wants the newest frame, queue_size=1 in the
    reference).
    """

    def __init__(self, callback: Callable[[float, object, object], None],
                 slop: float = 0.1, queue_size: int = 1):
        self.callback = callback
        self.slop = slop
        self.queues: Tuple[Deque, Deque] = (deque(maxlen=queue_size),
                                            deque(maxlen=queue_size))
        self._lock = threading.Lock()

    def add(self, channel: int, stamp: float, msg) -> bool:
        """Feed one message; fires ``callback(stamp, rgb_msg, depth_msg)``
        when a pair forms. Returns True when a pair fired."""
        if channel not in (0, 1):
            raise ValueError(channel)
        other = self.queues[1 - channel]
        with self._lock:
            best = None
            for i, (s, _) in enumerate(other):
                d = abs(s - stamp)
                if d <= self.slop and (best is None or d < best[0]):
                    best = (d, i)
            if best is not None:
                s_o, m_o = other[best[1]]
                del other[best[1]]
                pair = (msg, m_o) if channel == 0 else (m_o, msg)
                fire_stamp = min(stamp, s_o)
            else:
                self.queues[channel].append((stamp, msg))
                return False
        self.callback(fire_stamp, *pair)
        return True


def intrinsics_to_paras(k) -> np.ndarray:
    """CameraInfo.K (row-major 3x3) -> [fx, fy, cx, cy]
    (ros_demo.py:201-202)."""
    k = np.asarray(k, np.float64).reshape(3, 3)
    return np.array([k[0, 0], k[1, 1], k[0, 2], k[1, 2]], np.float32)


def decode_depth(data: np.ndarray, encoding: str) -> np.ndarray:
    """Depth image payload -> float32 meters (ros_demo.py:224-231).

    '32FC1' passes through; '16UC1' is millimeters / 1000. Anything else
    raises ValueError (the reference logs-and-skips; callers decide)."""
    if encoding == "32FC1":
        return np.asarray(data, np.float32)
    if encoding == "16UC1":
        return np.asarray(data, np.float32) / 1000.0
    raise ValueError(
        f"Unsupported depth type. Expected 16UC1 or 32FC1, got {encoding}")


class HandNetRosNode:
    """Transport-agnostic core: synced frame pairs in, published results out.

    Args:
      server: a started port :class:`PipelineServer`.
      publish: ``callable(topic: str, payload: dict)`` — the transport's
        publisher hook (rclpy publishers, or a test sink).
      paras: [fx, fy, cx, cy]; set later via :meth:`set_camera_info` when it
        comes from the CameraInfo topic.
      slop: synchronizer tolerance in seconds (reference uses 0.1).
    """

    def __init__(self, server, publish: Callable[[str, dict], None],
                 paras: Optional[np.ndarray] = None, slop: float = 0.1,
                 stream_id: str = "ros"):
        self.server = server
        self.publish = publish
        self.paras = None if paras is None else np.asarray(paras, np.float32)
        self.stream_id = stream_id
        self.sync = ApproximateTimeSynchronizer(self._on_pair, slop=slop)
        self._seq = 0
        self._meta = {}
        self._lock = threading.Lock()

    def set_camera_info(self, k) -> None:
        self.paras = intrinsics_to_paras(k)

    # -- input side ---------------------------------------------------------

    def on_rgb(self, stamp: float, rgb: np.ndarray) -> None:
        self.sync.add(0, stamp, rgb)

    def on_depth(self, stamp: float, depth: np.ndarray,
                 encoding: str = "32FC1") -> None:
        if (encoding == "16UC1"
                and getattr(self.server, "quantized_transfer", False)):
            # 16UC1 IS the server's uint16-mm wire format: pass through
            # untouched instead of mm->float32-m here and float32->mm again
            # in submit (2 full-frame converts + a 4x larger sync buffer)
            self.sync.add(1, stamp, np.asarray(depth, np.uint16))
            return
        try:
            depth_m = decode_depth(depth, encoding)
        except ValueError:
            return  # unsupported encoding: skip frame (ros_demo.py:232-236)
        self.sync.add(1, stamp, depth_m)

    def _on_pair(self, stamp: float, rgb: np.ndarray,
                 depth: np.ndarray) -> None:
        with self._lock:
            fid = self._seq
            self._seq += 1
            self._meta[fid] = stamp
        self.server.submit(self.stream_id, fid, rgb, depth)

    # -- output side --------------------------------------------------------

    def drain(self, timeout: Optional[float] = 0.0) -> int:
        """Publish every finished frame currently available; returns count.
        Call from the transport's spin loop (or a timer)."""
        import queue as _q

        n = 0
        processed = 0
        limit = None
        while limit is None or processed < limit:
            try:
                sid, fid, out = self.server.get(
                    timeout=timeout if processed == 0 else 0.0)
            except _q.Empty:
                break
            if limit is None:
                # bound this pass to what was queued when it started, so
                # re-queued foreign results aren't popped again in a spin
                limit = 1 + self.server.results.qsize()
            processed += 1
            if sid != self.stream_id:
                # another node's stream on the shared server: put it back
                # for its owner instead of dropping it
                self.server.results.put((sid, fid, out))
                continue
            with self._lock:
                stamp = self._meta.pop(fid, None)
            payload = {"stamp": stamp, "frame_id": fid,
                       **{k: np.asarray(v) for k, v in out.items()}}
            if self.paras is not None and "joints_uvd" in out:
                import torch

                from handnet_tpu_torch.ops.geometry import convert_joints

                payload["joints_xyz"] = convert_joints(
                    torch.from_numpy(np.asarray(out["joints_uvd"])[None]),
                    torch.from_numpy(np.asarray(out["boxes"])[None]),
                    torch.from_numpy(self.paras[None]),
                    self.server.cfg.pipeline.crop_size,
                    self.server.cfg.pipeline.crop_size).numpy()[0]
            self.publish("hand_pose", payload)
            n += 1
        return n


def run_rclpy(argv=None):  # pragma: no cover - needs a ROS 2 environment
    """The actual ROS 2 node (lazy rclpy import)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--rgb", default="/head_camera/rgb/image_raw")
    parser.add_argument("--depth", default="/head_camera/depth/image_raw")
    parser.add_argument("--camera-info",
                        default="/head_camera/depth/camera_info")
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--frame-hw", type=int, nargs=2, default=[480, 640])
    parser.add_argument("--device", default=None,
                        help="torch device to serve on (default: the card)")
    args = parser.parse_args(argv)

    import rclpy
    from rclpy.node import Node
    from sensor_msgs.msg import CameraInfo, Image
    from std_msgs.msg import Float32MultiArray

    from handnet_tpu_torch.apps.serve import PipelineServer

    server = PipelineServer(batch_size=args.batch,
                            frame_hw=tuple(args.frame_hw),
                            flush_timeout=0.01, device=args.device).start()

    rclpy.init()
    node = Node("handnet_tpu_torch")
    pose_pub = node.create_publisher(Float32MultiArray, "hand_pose", 10)

    def publish(topic, payload):
        msg = Float32MultiArray()
        msg.data = [float(x) for x in
                    np.asarray(payload["joints_uvd"]).reshape(-1)]
        pose_pub.publish(msg)

    core = HandNetRosNode(server, publish)

    def _img_to_np(msg):
        a = np.frombuffer(bytes(msg.data), dtype=np.uint8)
        return a.reshape(msg.height, msg.width, -1)

    def on_rgb(msg):
        core.on_rgb(msg.header.stamp.sec + msg.header.stamp.nanosec * 1e-9,
                    _img_to_np(msg)[:, :, :3].astype(np.float32) / 255.0)

    def on_depth(msg):
        if msg.encoding == "16UC1":
            d = np.frombuffer(bytes(msg.data), np.uint16).reshape(
                msg.height, msg.width)
        else:
            d = np.frombuffer(bytes(msg.data), np.float32).reshape(
                msg.height, msg.width)
        core.on_depth(msg.header.stamp.sec + msg.header.stamp.nanosec * 1e-9,
                      d, msg.encoding)

    def on_info(msg):
        core.set_camera_info(msg.k)

    node.create_subscription(Image, args.rgb, on_rgb, 10)
    node.create_subscription(Image, args.depth, on_depth, 10)
    node.create_subscription(CameraInfo, args.camera_info, on_info, 10)
    node.create_timer(0.005, lambda: core.drain(0.0))
    try:
        rclpy.spin(node)
    finally:
        server.stop()
        rclpy.shutdown()


if __name__ == "__main__":
    run_rclpy()
