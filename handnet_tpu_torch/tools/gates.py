"""What the two learning gates share: the synthetic task's split and
ground truth, the frame readers, the training loop, the detection tally
and both PASS rules.

Each piece is the port of lines that the JAX package's tools write inline
(``tools/synthetic_e2e_validation.py``, ``tools/rcnn_convergence.py``):

* :func:`split_indices`: every fifth frame of the DexYCB ``s0`` train split
  held out (``synthetic_e2e_validation.py:86-87``);
* :func:`generation_key`: a frame's key into ``make_synthetic_dexycb``'s
  info dict (``:281-286``): the split filters sequences, so the dataset's
  sequence index is not the generation index;
* :func:`padded_box`: the planted box padded by 40% and clipped to the
  640x480 frame, as the pipeline pads its crop box (``:303-309``);
* :func:`e2e_passes` and :func:`rcnn_passes`: the PASS rules
  (``:340-349``; ``rcnn_convergence.py:204-206``);
* :class:`DetectionTally`: found rate, best-box IoU and COCO AP of a
  held-out sweep (``rcnn_convergence.py:132-161``);
* :func:`train_steps`: the step loop that both tools run for each net
  (``synthetic_e2e_validation.py:105-131``, ``:148-166``;
  ``rcnn_convergence.py:74-96``), with its clock and loader-wait share,
  and :func:`train_detector`, its detector feed;
* :func:`pipeline_config` and :func:`assemble_pipeline`: the serving
  pipeline built from the two trained models (``:234-255``), and
  :func:`handoff_errors`, which holds it against the trainers' own eval
  forwards.

Frames are read by the port's JPEG and PNG readers (``data/image_io.py``),
which decode as ``cv2.imread`` does.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from handnet_tpu_torch.apps import train_fcos
from handnet_tpu_torch.config import HandNetConfig, PipelineConfig
from handnet_tpu_torch.data import image_io
from handnet_tpu_torch.data.loader import PrefetchLoader
from handnet_tpu_torch.data.synthetic import synthetic_sequence_number
from handnet_tpu_torch.eval.coco_det import CocoDetEvaluator
from handnet_tpu_torch.eval.voc import Detection, GTObject
from handnet_tpu_torch.models.fcos import FCOSSystem
from handnet_tpu_torch.models.pipeline import HandNetPipeline
from handnet_tpu_torch.ops.boxes import box_iou

FRAME_H, FRAME_W = 480, 640     # make_synthetic_dexycb's frames
HELD_OUT_EVERY = 5              # frame i is held out when i % 5 == 4
PAD = 0.4                       # the pipeline's crop padding, and the A2J samples'
SCORE_THRESH = 0.5              # both tools' detection threshold
FOUND_SHARE = 0.8               # PASS: found in at least 80% of held-out frames
IOU_BAR = 0.5                   # PASS: mean IoU above it
MPJPE_BAR_MM = 60.0             # PASS: mean MPJPE below it
AP50_BAR = 0.5                  # the R-CNN's PASS: AP50 at least it
LOG_EVERY = 50                  # steps between loss lines
WORKERS = 4                     # loader threads of every training stage


def split_indices(n: int) -> Tuple[List[int], List[int]]:
    """``(train, held_out)`` indices of a dataset of ``n`` frames."""
    train = [i for i in range(n) if i % HELD_OUT_EVERY != HELD_OUT_EVERY - 1]
    held_out = [i for i in range(n) if i % HELD_OUT_EVERY == HELD_OUT_EVERY - 1]
    return train, held_out


def generation_key(ds, i: int) -> Tuple[int, int]:
    """``(sequence, frame)`` of dataset frame ``i`` in the generator's
    numbering, the key of ``make_synthetic_dexycb``'s info dict."""
    s, _, f = ds._mapping[i]
    return synthetic_sequence_number(ds._sequences[int(s)]), int(f)


def padded_box(hand_box, pad: float = PAD, width: int = FRAME_W,
               height: int = FRAME_H) -> np.ndarray:
    """The planted box ``[x1, y1, x2, y2]`` padded by ``pad`` of its width
    and height on each side and clipped to the frame, in the box's own
    precision (the info dict's float32)."""
    x1, y1, x2, y2 = hand_box
    w, h = x2 - x1, y2 - y1
    return np.array([max(0, x1 - pad * w), max(0, y1 - pad * h),
                     min(width, x2 + pad * w), min(height, y2 + pad * h)])


def iou(box, gt) -> float:
    """IoU of two ``[4]`` boxes through ``ops/boxes.box_iou`` in float32."""
    a = torch.as_tensor(np.asarray(box, np.float32)[None])
    b = torch.as_tensor(np.asarray(gt, np.float32)[None])
    return float(box_iou(a, b)[0, 0])


def e2e_passes(n_held_out: int, found: int, ious: Sequence[float],
               mpjpes: Sequence[float], found_q: Optional[int] = None,
               mpjpes_q: Optional[Sequence[float]] = None) -> bool:
    """``VALIDATION: PASS``: the float pipeline found the hand in at least
    80% of the held-out frames with a mean IoU above 0.5 and a mean MPJPE
    under 60 mm; with an int8 pipeline (``found_q`` given) that one too
    finds 80% under 60 mm."""
    ok = (found >= FOUND_SHARE * n_held_out and len(ious) > 0
          and float(np.mean(ious)) > IOU_BAR
          and len(mpjpes) > 0 and float(np.mean(mpjpes)) < MPJPE_BAR_MM)
    if found_q is not None:
        ok = (ok and found_q >= FOUND_SHARE * n_held_out and len(mpjpes_q or ()) > 0
              and float(np.mean(mpjpes_q)) < MPJPE_BAR_MM)
    return bool(ok)


def rcnn_passes(found_rate: float, ap50: float, smoke: bool = False) -> bool:
    """``RCNN CONVERGENCE: PASS``: found in at least 80% of the held-out
    frames and AP50 at least 0.5; a smoke run (``RCNN_SMOKE``) passes on
    finishing, as the JAX tool's does."""
    return bool((found_rate >= FOUND_SHARE and ap50 >= AP50_BAR) or smoke)


def read_rgb(sample: Dict) -> np.ndarray:
    """A dataset item's colour frame, RGB ``uint8 [H, W, 3]``."""
    return np.ascontiguousarray(image_io.imread_color(sample["color_file"])[:, :, ::-1])


def read_depth(sample: Dict) -> np.ndarray:
    """A dataset item's depth frame in metres, ``float32 [H, W]``."""
    return image_io.read_png(sample["depth_file"]).astype(np.float32) / 1000.0


def frames_01(rgb: np.ndarray, device) -> torch.Tensor:
    """``[B, H, W, 3]`` uint8 RGB (or one ``[H, W, 3]`` frame) as 0-1
    float32 frames on ``device``."""
    rgb = rgb[None] if rgb.ndim == 3 else rgb
    return torch.from_numpy(rgb.astype(np.float32) / 255.0).to(device)


class DetectionTally:
    """Found rate, best-box IoU against the planted box and COCO AP of a
    held-out sweep, one :meth:`add` per frame."""

    def __init__(self):
        self.annotations: Dict[str, List[GTObject]] = {}
        self.detections: List[Detection] = []
        self.ious: List[float] = []
        self.found = 0
        self.frames = 0

    def add(self, image_id: str, gt_box, valid, boxes, scores) -> None:
        """One frame's padded detections (``valid [K]``, ``boxes [K, 4]``
        in frame pixels, ``scores [K]``) against its planted ``gt_box``."""
        valid, boxes, scores = (np.asarray(a) for a in (valid, boxes, scores))
        gt_box = np.asarray(gt_box, float)
        self.frames += 1
        self.annotations[image_id] = [GTObject("hand", gt_box)]
        if valid.any():
            self.found += 1
            best = int(np.argmax(np.where(valid, scores, -1)))
            self.ious.append(iou(boxes[best], gt_box))
            for k in np.nonzero(valid)[0]:
                self.detections.append(Detection(image_id, float(scores[k]), boxes[k]))

    def summary(self, net: str) -> Dict[str, float]:
        """The tool's JSON record: found rate, mean IoU, AP, AP50, AP75."""
        coco = CocoDetEvaluator(self.annotations).evaluate(
            self.detections, ["hand"] * len(self.detections))
        return {"net": net,
                "found_rate": round(self.found / max(self.frames, 1), 4),
                "mean_iou": round(float(np.mean(self.ious)) if self.ious else 0.0, 4),
                "AP": round(coco["AP"], 4), "AP50": round(coco["AP50"], 4),
                "AP75": round(coco["AP75"], 4)}


def train_steps(trainer, state, loader, steps: int, to_batch: Callable, tag: str):
    """``steps`` train steps over ``loader``'s passes (``set_epoch`` is the
    step count at each pass's start). The losses stay on the device but for
    the first one and every 50th, so the host runs ahead of the card.
    Returns ``(state, stats)``: first and last total loss, steps, seconds,
    steps/s and the share of the seconds spent waiting on the loader."""
    start = time.perf_counter()
    waited, step, first, last = 0.0, 0, None, None
    while step < steps:
        loader.set_epoch(step)
        batches = iter(loader)
        took = 0
        try:
            while step < steps:
                w0 = time.perf_counter()
                batch = next(batches, None)
                waited += time.perf_counter() - w0
                if batch is None:
                    break
                state, metrics = trainer.train_step(state, to_batch(batch))
                step, took, last = step + 1, took + 1, metrics["total_loss"]
                if first is None:
                    first = float(last)
                if step % LOG_EVERY == 0:
                    print(f"  [{tag}] step {step}: loss={float(last):.4f}", flush=True)
        finally:
            batches.close()
        if not took:
            raise ValueError(f"{tag}: the loader gives no batch of {loader.batch_size} "
                             f"from {len(loader.source)} samples")
    last = float(last)   # waits for the last step
    seconds = time.perf_counter() - start
    print(f"  [{tag}] loss {first:.3f} -> {last:.3f} ({seconds:.1f}s, "
          f"{step / seconds:.2f} steps/s, {100 * waited / seconds:.1f}% waiting on the loader)",
          flush=True)
    return state, {"steps": step, "first_loss": first, "last_loss": last, "seconds": seconds,
                   "steps_per_s": step / seconds, "loader_wait_share": waited / seconds}


def train_detector(trainer, state, source, steps: int, batch: int, tag: str):
    """:func:`train_steps` of an ``FCOSTrainer`` or ``RCNNTrainer`` on a
    ``DetectDataSource``: the loader's threads decode and pin each batch,
    the frames are preprocessed on the device and the boxes scaled into
    network pixels (``apps/train_fcos.py``'s ``device_batch``)."""
    device = trainer.device
    loader = PrefetchLoader(source, batch, shuffle=True, num_workers=WORKERS,
                            device_put=train_fcos.pinned(device))
    return train_steps(trainer, state, loader, steps, lambda b: train_fcos.device_batch(
        b, state.model, trainer.model_cfg, device), tag)


def pipeline_config(fcfg, acfg, crop: int, quant=False) -> HandNetConfig:
    """The pipeline of the two trained stages: the detector at a 0.5 score
    threshold (a quickly trained detector rarely clears the reference's
    0.7), 40% padded crops of ``crop`` pixels, and both stages at
    ``quant`` (False, True for dynamic int8, or "static")."""
    return HandNetConfig(
        a2j=dataclasses.replace(acfg, quant=quant),
        fcos=dataclasses.replace(fcfg, score_thresh=SCORE_THRESH, quant=quant),
        pipeline=PipelineConfig(crop_size=crop, pad_percent=PAD))


def assemble_pipeline(cfg: HandNetConfig, fmodel, amodel, dtype=torch.bfloat16,
                      device=None) -> HandNetPipeline:
    """A ``HandNetPipeline`` holding the trained detector (``fmodel``, an
    ``FCOSSystem`` or its state dict) and A2J (``amodel``, likewise). Their
    batch norms' weights and running statistics load into the pipeline's
    frozen norms under the same names; a static int8 pipeline's activation
    scales stay to be calibrated. Any other key that does not match raises
    ``KeyError``."""
    pipe = HandNetPipeline(cfg, dtype=dtype, device=device)
    for name, part, model in (("detector", pipe.detector, fmodel), ("a2j", pipe.a2j, amodel)):
        state = model if isinstance(model, dict) else model.state_dict()
        missing, unexpected = part.load_state_dict(state, strict=False)
        missing = [k for k in missing if not k.endswith("act_amax")]
        if missing or unexpected:
            raise KeyError(f"assemble_pipeline: {name}: missing {missing[:3]}, "
                           f"unexpected {unexpected[:3]}")
    return pipe


@torch.no_grad()
def handoff_errors(pipe: HandNetPipeline, fmodel, atrainer, astate,
                   images: torch.Tensor, depth: torch.Tensor) -> Dict[str, float]:
    """The assembled float ``pipe`` against the trainers' own eval
    forwards on 0-1 frames ``images`` and depth ``depth``: the largest
    difference of its detections' boxes and scores from ``FCOSSystem.detect``
    of the trained detector (its batch norms on their running statistics)
    at the pipeline's config, its joints' from ``atrainer.eval_step`` on
    the pipeline's own crops, and how many detections and frames were
    compared."""
    ref = FCOSSystem(dataclasses.replace(pipe.cfg.fcos, quant=False), backbone_norm="batch")
    ref.load_state_dict(fmodel.state_dict())
    ref.to(images.device, memory_format=torch.channels_last).eval()
    got, want = pipe.detect(images), ref.detect(images)
    if not torch.equal(got["valid"], want["valid"]):
        raise AssertionError("handoff: the pipeline keeps other detections than the trained "
                             "detector")
    valid = want["valid"]
    box_err = (got["boxes"] - want["boxes"]).abs()[valid]
    score_err = (got["scores"] - want["scores"]).abs()[valid]
    out = pipe(images, depth)
    pred, _ = atrainer.eval_step(astate, {"image": out["crops"],
                                          "jt_uvd": torch.zeros_like(out["joints_uvd"])})
    found = out["found"]
    joint_err = (out["joints_uvd"] - pred)[found].abs()
    return {"box": float(box_err.max()) if box_err.numel() else 0.0,
            "score": float(score_err.max()) if score_err.numel() else 0.0,
            "joints": float(joint_err.max()) if joint_err.numel() else 0.0,
            "detections": int(valid.sum()), "found": int(found.sum())}
