#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``handnet_tpu_torch``) on one NVIDIA card.

Run from the repository root, with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device, ``nvcc`` and ``nvidia-smi``, and no network; it
imports nothing of jax or of the JAX package. Phases, each printing before
the next starts:

1. card: ``nvidia-smi`` name and power limit, torch and CUDA versions.
2. build: compiles ``handnet_tpu_torch/csrc/*.cu`` for sm_90a (first use).
serve: the serving tier at 480x640, bf16, buckets 1, 8 and 128, seeded
   random weights, score threshold 0. ``PipelineServer`` captures one CUDA
   graph per bucket (``graphs.py``; the eager warm-up and capture calls must
   launch K1 1, K2s and K2a 24, K3q and K3g 0 or 129 times per call), and a
   replay must equal the eager forward of the same bucket bit for bit, at
   B=1, 8 and 128, for fast and for calibrated quant_static, while launching
   nothing through the wrappers. A fast server fed by 4 host threads with
   512 frames returns each frame once with its ids and no error, and a
   full and a partial dispatch equal the eager forward of their padded
   batch bit for bit; it prints ``sustained_fps``, ``compute_fps_probe()``,
   ``latency_stats()`` and ``bucket_dispatches``. Then a trickle of 16
   single frames (bucket 1, p50/p99), one injected failing dispatch (error
   results, the server goes on), and the fast and the quant_static forward's
   ms per call at B=1, 8 and 128, eager against replay, in turns. Last,
   calibrated quant_static is exported (``export.export_pipeline``,
   quantized wire) under ``build/serve_artifact``; a fresh interpreter that
   must not import jax, the JAX package or ``handnet_tpu_torch.models``
   loads it, predicts 1 frame (bucket 1), 3 (bucket 8, pad 5 > 3) and 130
   (128 + 2), which must equal the live pipeline at the same buckets bit
   for bit, times a replay of each bucket (beside the live quant_static
   replay above), and serves 64 frames through
   ``PipelineServer.from_artifact``.
3. kernels: every kernel against its plain PyTorch version, and its time
   twice: by a loop of wrapper calls between two CUDA events (``cuda_ms``,
   which the host bounds when the kernel is short) and by the kernel's own
   duration on the device (``device_ms``, torch.profiler).
   K1 (A2J decode) at B = 1, 8 and 128 in float32 and bfloat16, two runs
   bit-equal, an unaligned shape, strided views refused. K2s (GroupNorm
   statistics) and K2a (normalize, affine, ReLU) at the three FPN levels, B =
   1, 8 and 128, float32 and bfloat16: K2s to 1e-4 of scale with two runs
   bit-equal and the mean >> std case, K2a bit for bit with and without the
   ReLU; beside them ``torch.var_mean`` (K2s's function in one call) and
   ``F.group_norm`` (+ ``F.relu``) on the same channels_last bytes (K2s +
   K2a's), which the port never calls; and a profile of one ``group_norm``
   call, which must show those two kernels and nothing else.
   K3q (activation quantize pass) bit for bit against its plain version in
   float32 and bfloat16, per-layer and per-sample scales, near-tie and ReLU
   inputs. K3 (int8 conv: K3q, then K3g, the TMA-fed wgmma GEMM) bit for
   bit against its plain version on every distinct conv geometry of the
   quant_static path at 480x640 / 176^2 crops: at B=8 in float32 and
   bfloat16 with a per-layer and a per-sample scale, and at B=128 in
   bfloat16, where K3q, K3g, both together and the plain version are
   timed, per geometry and summed by class. Then K3g's two yardsticks at
   the P3 tower shape (``torch._int_mm`` on the ready GEMM operands,
   ``F.conv2d`` in bf16), which the port never calls, and the host time of
   a call's 129 tensor-map encodings.
4. slice: ``HandNetPipeline`` at the fast operating point (480x640, full
   widths, seeded random weights, score threshold 0) answers three batches
   of 8 and one of 128 in bf16 through the kernels; the launch counts must
   be K1 once and K2s and K2a 24 times each per call. Then the float32
   kernel path is held against the plain path on the card and against the
   port's own CPU run. Then the same for the quant_static profile (int8
   convs, JAX package's benchmark default), calibrated on seeded frames
   first, with K3q and K3g 129 times each per call (113 int8 layers, the 8
   tower convs at 3 levels); in the pipeline K3 is also held bit for bit
   against its plain version; and one batch of 8 of the dynamic quant
   profile.
5. geometries: K2s and K2a at the parity FPN levels (C=256, G=32) and at
   the fused towers' C=512, G=64 (480x640 and 800x1088 levels), under the
   rules of phase 3, with their B=128 times also on fresh inputs (cold
   L2); the parity resize (two float32 matmuls) against its byte bound and
   the CPU; the plain and the space-to-depth stem against each other and
   timed; then the parity profile (800x1088) as the slice (K1 1, K2s and
   K2a 24 per call), parity with calibrated int8 (K3q and K3g 129 per call,
   K3 bit-equal to its plain version in the pipeline at B=8 and B=128),
   turbo (2-conv towers, K2s and K2a 12), the fused-tower head (K2s and K2a
   12 at C=512, its head outputs against the unfused head's) and a detector
   with the 100DOH extension heads (``pipe.detect``, K2s and K2a 24) against
   the CPU.
6. throughput: frames/s at batch 128 in bf16: fast with kernels and plain
   versions, quant_static with K3 and with K3's plain version, in turns;
   then a per-stage split of fast and quant_static (CUDA events), the
   latency of a batch of 8, and a profile of quant_static by kernel; then
   parity and turbo with kernels and plain versions, the fused and the
   unfused towers, in turns, parity int8, and a stage split of parity;
   then the mesh phase below; last, the share of the wall time in which no
   kernel runs (torch.profiler) for the fast forward at B=8 and 128, eager
   and as a graph replay.
mesh: the fast operating point with the fused mesh head
   (``pipeline.with_mesh``: PoseNet 4096 wide, 2 stages, Chebyshev order 3,
   the 6-level pyramid of the 778-vertex strip stand-in) at 480x640, seed
   2, score threshold 0. bf16 calls of batch 8, 8 and 128 through the
   kernels, K1 once and K2s and K2a 24 times per call; the head alone
   (normalize + Pose2Mesh + vertex order) at B=128, device and loop time
   against its bound (its products' FLOPs at the dense bf16 peak), and its
   kernels by the profiler; frames/s at B=128 with and without the head,
   in turns; a server with buckets 8 and 128 and ``"verts"`` among its
   fields: replay == eager bit for bit at B=8 and 128, 32 frames served
   from 2 threads, dispatches == their padded eager batch; a with_mesh
   artifact (bucket 8) whose ``predict`` == eager bit for bit; in float32
   the kernel path against the plain path and the CPU run on verts and
   verts_xyz, and the head alone, card against CPU, on the same joints;
   one calibrated quant_static batch of 8 (K3q and K3g 129); the MANO
   layer at B=128 in float32 against its CPU run on synthetic assets, and
   its time.

train (after mesh, before the idle shares): ``FCOSTrainer`` at the width of
   the 100DOH training run (800x1088, ResNet-34, FPN 256, 4-conv GN(32)
   towers, the extension heads, 3 classes; batch 8, SGD lr 1.25e-3 with
   warmup, bf16, a batch-norm backbone) on a seeded synthetic batch (480x640
   frames with 1-4 boxes each, padded to 8, through ``preprocess``).
   GroupNorm + ReLU at the P3 train shape [8, 100, 136, 256], float32 and
   bf16: K2s + K2a and the ops' registered backward against autograd
   through the plain versions (dx, dscale, dbias), and forward + backward
   timed beside ``F.group_norm`` + autograd; the matcher at 800x1088 with a
   float32 area tie, card == CPU; one step of two trainers from one seed
   with the kernels and with their plain versions, bf16 and float32 (TF32
   off): every loss term and every parameter's gradient; 20 steps on the
   repeated batch (K2s and K2a 24 launches per step, K1 and K3 none; every
   loss finite, the last total below half the first, master weights
   float32), ms per step by the loop clock after 3 steps, images/s, peak
   memory, and a profile of one step by kernel (top 10, K2s/K2a's share, the
   GroupNorm backward's share from its profiler ranges); one step with a
   frozen backbone (running statistics unchanged, its affine moved).

train_a2j (after train): ``A2JTrainer`` at apps/train_a2j.py's recipe
   (176^2 depth crops, dilated ResNet-50, three 256-wide 4-conv towers, 16
   anchors, 21 joints; batch 64, AdamW 3.5e-4, bf16, batch-norm A2J) on a
   seeded synthetic batch (a hand of discs nearer than the background, in
   build_a2j_sample's ranges). One float32 step (TF32 off) at batch 8,
   card against CPU from one seed: every loss term and every parameter's
   gradient; 20 steps on the repeated batch (no kernel of the port launched;
   every loss finite, the last total below half the first, master weights
   float32), ms per step by the loop clock after 3 steps, samples/s, peak
   memory; a profile of one step (top 10) and the 65 BatchNorm layers'
   forward + backward alone, as a share of the step; the eval step through
   K1 (one launch) twice, bit-equal, against the same step with the plain
   decode (pred and rmse).

train_mesh (after train_a2j): the Pose2Mesh app (apps/train_pose2mesh.py,
   PoseNet 4096 x 2, Chebyshev order 3, the strip stand-in's pyramid with
   the app's HORI joint graph; batch 32, Adam 1e-4, float32, TF32 off):
   one step card against CPU on one batch and init (every loss term), then
   ``main`` with ``--synthetic --steps 20 --device cuda`` into a temporary
   directory: no kernel of the port launched, params.npz in the flax keys,
   ms per step by the loop clock, peak memory, and the loss on the first
   batch after the 20 steps below the first step's.

a2j_apps (after train_mesh, before the idle shares): the A2J apps through
   their entry points. The port's synthetic DexYCB tree (64 sequences x 4
   frames, 480x640: 208 s0-train samples, also the eval set); one host
   core's cost of decoding a depth PNG with each filter and of building a
   sample (and, where cv2 is installed, the port's resamplers against it,
   printed only); ``train_a2j.main`` at the recipe (crop 176, batch 64,
   bf16, 3 epochs, an eval sweep after each, 8 loader threads): per epoch
   ms per step, samples/s and the share spent waiting on the loader, K1
   ceil(208 / 64) = 4 times per sweep and no other launch, 64-field
   result lines, finite HPE numbers, params.npz and batch_stats.npz, the
   last epoch's mean loss below the first's; a train step alone and beside
   8 busy loader threads; ``eval_hpe.main`` on the last result file ==
   the CLI's numbers; ``a2j_infer.main`` twice over 256 of the tree's PNGs
   at batch 64 with the CLI's params.npz (K1 4 launches each; all_joints_
   uvd [256, 21, 3] finite, == the plain decode within 1e-2 px), frames/s
   with the host decode.
fcos_apps (after a2j_apps, before the idle shares): the FCOS apps through
   their entry points. K2s/K2a at the GroupNorm backbone's five shapes
   (batch 8 at 800x1088, C/G 2-16; 36 layers) against their plain
   versions, timed with bounds; the port's synthetic tree with colour (20
   sequences x 4 frames: 64 s0-train samples) and a VOC tree of 32 JPEGs
   made of its first 16 frames at 480x640 and at 600x800; where cv2
   imports, the port's JPEG decode of all 112 files == cv2.imread (a gate)
   and its encode and resize against cv2 (printed), with decode and encode
   ms per 480x640 frame on one core; ``train_fcos.main`` at the recipe
   (800x1088, batch 8, bf16, batch-norm backbone, 2 epochs, 8 loader
   threads): ms per step, images/s, the loader-wait share, K2s/K2a 24 per
   step and nothing else, finite losses; a train step alone and beside 8
   busy loader threads; ``train_fcos.main --voc-root --backbone-norm
   group`` (1 epoch): K2s/K2a 60 per step, the trained backbone's
   GroupNorms == their plain versions on one batch (f32, 1e-3 of each
   level's scale); ``eval_fcos.main`` with the first run's weights
   (reference-keyed, classes 0, 1 and 22 as background, object and hand):
   11-field rows, finite AP, K2s/K2a 24 per call, FPS, the same CLI with
   the plain GroupNorm and with random weights (printed), and its detect
   in float32 == the plain GroupNorm within 1e-2 px; ``train_a2j.main
   --rgbd`` (1 epoch at the recipe): finite losses, K1 ceil(n / 64) per
   eval sweep.

demo_apps (after rcnn, on fcos_apps' tree): the demo apps through their
   entry points, on seed-2 weights written as reference-keyed FCOS and A2J
   checkpoints (the apps' ``--fcos-checkpoint``/``--a2j-checkpoint``).
   ``demo.main`` on the synthetic source: 32 frames of 480x640 into the
   default 800x1088 geometry, bf16, B=1, score threshold 0 (every frame
   found, joints finite, K2s/K2a 24 and K1 1 per frame and nothing else;
   steady-state frames/s and ms per frame, each frame until the card has
   finished it); again with ``--flip-left --render-mesh`` on 8 frames (one
   overlay PNG and a finite [778, 3] mesh per found frame, the saved xyz ==
   ``convert_joints`` of the saved uvd and box; the host's overlay ms per
   frame); the demo's pipeline in float32, kernels against plain versions
   (1e-2 px); ``FolderSource`` over 8 of the tree's colour/depth pairs (==
   ``cv2.imread`` where cv2 imports, a gate) and ``demo.main --source
   folder`` over them; ``a2j_mesh.main --synthetic 4 --limit 8`` (K1 8,
   finite joints and meshes, the npz keys); ``HandNetRosNode`` over a
   started fast ``PipelineServer`` (480x640, bf16, buckets 1/8/128): 32
   pairs, 16UC1 and 32FC1 in turns, and one pair outside the slop, each
   paired frame published once with its stamp, ``joints_xyz`` ==
   ``convert_joints`` of the payload, the payloads == the eager forward of
   each dispatch's padded wire batch within 1e-2 px; ``a2j_infer --vis``
   over 16 depth PNGs (one ``_vis.jpg`` each; where cv2 imports, the
   skeletons == cv2's circle/line and the files == ``cv2.imwrite``'s
   bytes); ``utils/statepack.py`` on train's and train_a2j's trained
   models (bit-equal back, the loaded A2J's predict through K1 == the
   saved one's).

The ``[card]`` line also gives scipy's version: the mesh head's graph
pyramid is built with it, and the script fails without it; and the host's
decoders (cv2 and the JPEG library it bundles, PIL, yaml, g++, libnvjpeg),
which the port does not use.

In the ``{"kernels": [...]}`` line ``ms``, ``plain_ms`` and ``library_ms``
are times on the device; ``loop_ms`` is the wrapper loop's; ``launches`` is
the quant_static run's, ``launches_per_call`` each path's (for the serving
paths, per eager warm-up or capture call: a replay launches through no
wrapper; ``train_fcos``, ``train_a2j`` and ``train_mesh`` per train step,
``eval_a2j`` per eval step, ``a2j_apps_eval`` per batch of the CLI's eval
sweeps, ``a2j_infer`` per batch of the app, ``train_fcos_app`` and
``train_fcos_voc_group`` per step of the CLI, ``eval_fcos`` per detect
call, ``train_a2j_rgbd_eval`` per eval batch, ``demo`` per frame,
``a2j_mesh`` per sample, ``ros_node`` per eager call of its server's
capture), K2s's and K2a's ``shapes``
hold their numbers at the shapes of phase 5, and ``backbone_shapes`` at
the GroupNorm backbone's.

Every kernel's bound is the larger of its bytes (inputs read once, outputs
written once) over 3.35 TB/s and its operations over the card's peak for
their type (1,979 TOP/s int8 in the tensor cores, 67 TFLOP/s float32
outside them, 989 TFLOP/s bf16 for the mesh head's products, which are not
a kernel of the port): the H100 SXM data sheet's rates at 700 W.

The line before the last is one JSON object ``{"kernels": [...]}``; the last
is ``{"ok": true, "device": {...}}``. Any failure raises, and the script
exits non-zero without that line.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import subprocess
import sys
import time

# Seed of the random weights. With seed 2 the detector's random weights rank
# the hand class (2) first on most anchors, so at score threshold 0 every
# frame takes the found path (seeds 0, 4, 5, 6 rank another class first on
# nearly every anchor, and no frame would).
SEED = 2
SLICE_REQUESTS = (8, 8, 8, 128)   # batch sizes of the slice's calls
GN_LAYERS_PER_CALL = 24           # 2 towers x 4 GroupNorms x 3 FPN levels
GN_LEVELS = ((60, 80), (30, 40), (15, 20))  # FPN P3-P5 at 480x640
INT8_LAYERS = 113                 # QuantConvs: 49 detector + 64 A2J
INT8_LAUNCHES_PER_CALL = 129      # 105 once, the 8 tower convs at 3 FPN levels
CALIBRATION_SEEDS = (500, 501)    # two seeded batches of 8 frames
# Joints of the int8 slice, two runs whose float layers round differently
# (kernels vs plain versions, card vs CPU): an int8 conv turns a last-bit
# difference at a rounding tie into a whole quantization step, so the
# joints agree to a few hundredths of a pixel, not to 1e-4 as in float.
INT8_JOINT_TOL = 5e-2
# H100 SXM data sheet, dense, at 700 W
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
F32_FLOPS_PER_S = 67e12
P3_TOWER = (60, 80, 256, 256, 3, 1, 1, 1, True)   # the towers' 3x3 at FPN level P3
PARITY_LEVELS = ((100, 136), (50, 68), (25, 34))  # FPN P3-P5 at 800x1088
GN_TURBO_PER_CALL = 12            # 2 towers x 2 GroupNorms x 3 levels
GN_FUSED_PER_CALL = 12            # 1 fused tower x 4 GroupNorms (C=512, G=64) x 3 levels
# the parity resize: B, frame, resized, padded to the network input
RESIZE_CASE = (128, (480, 640), (800, 1067), (800, 1088))
STEM_SIZES = ((480, 640), (800, 1088))    # the stem's input at fast and at parity
BF16_FLOPS_PER_S = 989e12         # H100 SXM dense bf16 tensor-core peak, at 700 W
MESH_REQUESTS = (8, 8, 128)       # batch sizes of the mesh path's calls
MESH_VERTS = 778
# the f32 mesh path, verts against the plain path and the CPU run, as a
# share of the verts' scale: the head is the same code on both sides, so
# what differs is its input, the joints (1e-2 px apart at most, 5e-2 from
# the CPU), divided by the joints' spread in the normalization
MESH_TOL_PLAIN = 1e-2
MESH_TOL_CPU = 5e-2
# the head alone on the same joints, card against CPU, f32, TF32 off
MESH_HEAD_TOL = 1e-4
# training (apps/train_fcos.py on 100DOH: FCOSConfig's defaults, 3 classes,
# batch 8, lr 1.25e-3, SGD, a one-epoch warmup, bf16, a batch-norm backbone)
TRAIN_BATCH = 8
TRAIN_LR = 1.25e-3
TRAIN_MAX_BOXES = 8               # DetectDataSource's max_boxes (data/detect_data.py:86)
TRAIN_FRAME = (480, 640)
TRAIN_STEPS = 20                  # the learning run, on one repeated batch
TRAIN_WARM_STEPS = 3              # steps before the loop clock starts
TRAIN_STEPS_PER_EPOCH = 5         # so the warmup ends at step 5 and the run learns at lr
# the last total loss of the learning run below half the first (measured on
# an H100 80GB HBM3 at 700 W: 0.141 of the first)
TRAIN_LEARN_SHARE = 0.5
GN_TRAIN_SHAPE = (8, 100, 136, 256)   # P3 of a train step at 800x1088, G=32
# K2s + K2a and the registered backward against autograd through the plain
# versions at GN_TRAIN_SHAPE, as a share of each gradient's largest |value|:
# float32 differs by the statistics' summation order; bf16 rounds dx to
# bf16 (an ulp is 2^-8 of a value) in two terms, each path after its own
# float32 arithmetic (measured: dx 1.9e-7 f32, 1.5e-3 bf16; dscale 3.5e-7)
GN_GRAD_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# the train step with kernels against the plain versions (same seed, same
# batch): each loss term (relative) and each parameter's gradient (norm of
# the difference over the norm), bf16 and float32 with TF32 off. The two
# differ by the statistics' last bits in the forward and by the gradient's
# formula (registered against autograd's through the plain ops), and cuDNN's
# weight gradients sum in no fixed order (measured: bf16 losses 1.4e-4,
# gradients median 1.7e-2, max 3.6e-2; f32 losses equal, gradients median
# 2.4e-4, max 4.4e-4)
TRAIN_KERNEL_TOL = {"bfloat16": {"loss": 2e-3, "grad": 0.15},
                    "float32": {"loss": 1e-5, "grad": 5e-3}}


# A2J training (apps/train_a2j.py: A2JConfig's defaults, batch 64, AdamW lr
# 3.5e-4 and wd 1e-4, StepLR 0.2 every 10 epochs, bf16, batch-norm A2J)
A2J_TRAIN_BATCH = 64
A2J_CHECK_BATCH = 8               # the float32 step held against the CPU
A2J_EVAL_CALLS = 3                # K1 twice (same bits), then the plain decode
# one float32 step (TF32 off), card against CPU from one seed: each loss
# term relative, and each parameter's gradient by the norm of the
# difference over the norm of the CPU's, median and worst over the tensors.
# This random ResNet-50 in train mode amplifies rounding: on the CPU, the
# port against itself on crops changed by 1e-6 relative gives losses 3e-7
# apart and gradients 2.3% apart (median) and 3.5% (worst), so the two
# devices, whose convolutions round differently, are held to twice and
# three times that. The biases of the head convs before a BatchNorm have an
# exact gradient of 0 (the norm removes them) and a computed one of
# rounding noise (1.5e-8 of the conv weight's): both sides must keep them
# below A2J_ZERO_GRAD of their weight's.
A2J_CPU_TOL = {"loss": 1e-4, "grad_median": 0.05, "grad_max": 0.1}
A2J_ZERO_GRAD = 1e-5
# the eval step through K1 against the same step with the plain decode:
# pred to 1e-4 of its scale (K1's own tolerance), rmse relative
A2J_EVAL_TOL = 1e-4
A2J_RMSE_TOL = 1e-5
# the A2J apps: apps/train_a2j.py at its recipe on the port's synthetic
# tree (--synthetic 64 at 480x640, 4 frames each: 52 s0-train sequences,
# 208 samples, which are also the eval set), then eval_hpe on its result
# file and a2j_infer over 256 of the tree's depth PNGs with its params.npz;
# a2j_infer's UVD through K1 against the same frames through the plain
# decode, in pixels
A2J_APPS_SEQUENCES = 64
A2J_APPS_CROP = 176
A2J_APPS_EPOCHS = 3
A2J_APPS_WORKERS = 8
A2J_INFER_FRAMES = 256
A2J_INFER_TOL = 1e-2
# the Pose2Mesh app (apps/train_pose2mesh.py's defaults: batch 32, Adam
# 1e-4, float32): 20 steps of new batches through main(); one step card
# against CPU, every loss term to 1e-4 relative (f32, TF32 off)
MESH_TRAIN_STEPS = 20
MESH_TRAIN_BATCH = 32
MESH_TRAIN_LR = 1e-4
MESH_CPU_TOL = 1e-4

# the FCOS apps ([fcos_apps]): apps/train_fcos.py on the port's synthetic
# tree at the 100DOH recipe (800x1088, batch 8, bf16, SGD 1.25e-3 with a
# one-epoch warmup, 8 loader threads; --synthetic 20 at 480x640, 4 frames
# each: 64 s0-train samples, 8 steps an epoch), then --voc-root on a VOC
# tree of 32 JPEGs (the synthetic tree's first 16 frames at 480x640, then
# at 600x800) with a GroupNorm backbone, eval_fcos on that tree with the
# first run's weights, and train_a2j --rgbd on the colour tree
FCOS_APPS_SEQUENCES = 20
FCOS_APPS_EPOCHS = 2
FCOS_APPS_WORKERS = 8
FCOS_APPS_VOC_SIZES = ((480, 640), (600, 800))
FCOS_APPS_VOC_PER_SIZE = 16
FCOS_APPS_EVAL_BATCH = 4
FCOS_APPS_EVAL_THRESH = 0.0       # eval_fcos --score-thresh: every kept detection is a row
FCOS_APPS_IMAGE = (800, 1088)     # FCOSConfig's network input, the 100DOH recipe's
BACKBONE_GN_LAYERS = 36           # ResNet-34: the stem, 2 per block, 3 downsamples
# ResNet-34's GroupNorm(32) shapes at 800x1088 (h, w, C, G) and layers of each
BACKBONE_GN_SHAPES = {(400, 544, 64, 32): 1, (200, 272, 64, 32): 6,
                      (100, 136, 128, 32): 9, (50, 68, 256, 32): 13, (25, 34, 512, 32): 7}
# the trained GroupNorm backbone, kernels against plain versions on one
# batch, float32 with TF32 off: each pyramid level's max |diff| over its
# max |value| (the statistics differ in their last bits, 36 layers deep)
FCOS_BACKBONE_GN_TOL = 1e-3
# eval_fcos's detect on one batch, float32 with TF32 off, with kernels
# against the plain GroupNorm: the same valid detections, boxes within this
# many px (bf16 runs of the CLI are compared too, and printed: near-tied
# scores and the 0.1 threshold make their row sets differ)
FCOS_EVAL_BOX_TOL = 1e-2

# [rcnn]: train_fcos/eval_fcos --net rcnn at the 100DOH recipe
RCNN_PROPOSALS = 128              # --num-proposals: the recipe's per-image budget
RCNN_EPOCHS = 2
RCNN_FROZEN_EPOCHS = 1            # the short --backbone-norm frozen run whose weights eval reads
RCNN_ROI = 7                      # RoIAlign's output, 7 x 7 bins of 2 x 2 taps
RCNN_NMS_CANDIDATES = 2 * RCNN_PROPOSALS
RCNN_TIMED_STEPS = 5
# [demo_apps]
DEMO_FRAMES = 32                  # demo.main on the synthetic source, B=1
DEMO_MESH_FRAMES = 8              # --flip-left --render-mesh
DEMO_FOLDER_FRAMES = 8            # --source folder over the synthetic tree
DEMO_TOL = 1e-2                   # px: kernels vs plain; served vs eager
A2J_MESH_SAMPLES = 8
ROS_PAIRS = 32
A2J_VIS_FRAMES = 16


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms over ``iters`` launches (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_rows(prof) -> list:
    """``(kernel name, ms on the device, launches)`` of a torch.profiler run."""
    return [(e.key, getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0)) / 1e3, e.count)
            for e in prof.key_averages()
            if getattr(e, "device_type", None) is not None and "CUDA" in str(e.device_type)]


# profiler sessions of device_ms, and those that lost kernel records
PROFILER_SESSIONS = {"sessions": 0, "short": 0, "lost_records": 0}


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time that the card spends in the kernels of one call of ``fn``:
    the kernels' own durations from torch.profiler, summed over ``iters``
    calls. Unlike :func:`cuda_ms` it leaves out whatever the host takes
    between launches, which bounds a loop of short kernels. ``fn`` may be a
    sequence of callables, taken in turn (inputs that together exceed the
    50 MB L2, so that every launch reads from device memory).

    Every kernel must show a whole number of launches per call: a session
    that lost some of its records (the profiler does, now and then) is
    taken again, and if three are short, each kernel is priced by the mean
    of its recorded launches times its launches per call. Should the
    profiler record nothing, the event loop's time stands in, and a line
    says so."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fns = fn if isinstance(fn, (list, tuple)) else [fn]
    for i in range(max(warmup, len(fns))):
        fns[i % len(fns)]()
    estimate = None
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fns[i % len(fns)]()
            torch.cuda.synchronize()
        rows = [(ms, n) for _, ms, n in device_rows(prof) if n > 0]
        PROFILER_SESSIONS["sessions"] += 1
        if not rows:
            continue
        if all(n % iters == 0 for _, n in rows):
            return sum(ms for ms, _ in rows) / iters
        PROFILER_SESSIONS["short"] += 1
        PROFILER_SESSIONS["lost_records"] += sum(
            max(1, round(n / iters)) * iters - n for _, n in rows)
        estimate = sum(ms / n * max(1, round(n / iters)) for ms, n in rows)
    if estimate is not None:
        return estimate
    log("kernels", "device_ms: the profiler recorded no device time in three sessions; this "
        "time is the event loop's instead")
    return cuda_ms(fns[0], iters, warmup)


def bound(n_bytes: float, ops: float, ops_per_s: float) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over their peak rate, whichever is larger (ms)."""
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def check(name: str, got, want, tol: float) -> float:
    """Max abs error of ``got`` against ``want``; raises above ``tol``."""
    import torch

    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)} "
                             f"or non-finite values")
    err = (got.double() - want.double()).abs().max().item()
    if not err <= tol:
        raise AssertionError(f"{name}: max |err| {err:.3e} > tol {tol:.3e}")
    return err


def timed(fn) -> dict:
    """``fn``'s time by a loop of calls between two events (which the host
    bounds when the kernels are short) and by the kernels' own durations."""
    return {"loop_ms": cuda_ms(fn), "ms": device_ms(fn)}


def same_bits_twice(name: str, fn):
    """``fn()`` twice: the result, after checking that the runs agree bit for
    bit (the split reductions fold their partials in a fixed order)."""
    import torch

    first, second = fn(), fn()
    if not torch.equal(first, second):
        raise AssertionError(f"{name}: two runs on the same input differ")
    return first


def phase_a2j_kernel(dev) -> dict:
    """K1 against its plain version at B = 1, 8 and 128; returns the numbers
    of its JSON entry (everything but the launch count)."""
    import torch

    from handnet_tpu_torch.ops.anchors import a2j_anchor_grid
    from handnet_tpu_torch.ops.cuda_a2j import a2j_decode, a2j_decode_reference

    gen = torch.Generator(device=dev).manual_seed(SEED)
    # N=11*11*16, P=21. Outputs are pixel positions (|x| up to ~200 with these
    # offsets); tolerance 1e-4 of that scale: float32 accumulations in another
    # order, the same inputs on both sides.
    n, p = 1936, 21
    anchors = torch.from_numpy(a2j_anchor_grid(11, 11, 16)).to(dev)

    def inputs(b, dtype, n=n, p=p):
        return ((torch.randn(b, n, p, device=dev, generator=gen) * 2).to(dtype),
                (torch.randn(b, n, p, 2, device=dev, generator=gen) * 5).to(dtype),
                torch.randn(b, n, p, device=dev, generator=gen).to(dtype))

    def compare(name, args):
        want = a2j_decode_reference(*args)
        tol = 1e-4 * max(1.0, want.abs().max().item())
        got = same_bits_twice(name, lambda: a2j_decode(*args))
        return check(name, got, want, tol), tol

    errs, times = [], {}
    for b in (1, 8, 128):
        for dtype in (torch.float32, torch.bfloat16):
            c, r, d = inputs(b, dtype)
            err, tol = compare(f"K1 B={b} {dtype}", (c, r, d, anchors))
            errs.append(err)
            kernel = timed(lambda: a2j_decode(c, r, d, anchors))
            line = (f"K1 a2j_decode B={b} N={n} P={p} {dtype}: max|err| {err:.3e} (tol "
                    f"{tol:.1e}), two runs bit-equal; kernel on the device "
                    f"{kernel['ms']:.4f} ms, wrapper loop {kernel['loop_ms']:.4f} ms")
            if b == 128:
                plain = timed(lambda: a2j_decode_reference(c, r, d, anchors))
                times[dtype] = (kernel, plain)
                line += (f"; plain on the device {plain['ms']:.4f} ms, loop "
                         f"{plain['loop_ms']:.4f} ms")
            log("kernels", line)
    # four input sets in turn: 167 MB, so no launch finds its inputs in the L2
    sets = [inputs(128, torch.bfloat16) for _ in range(4)]
    cold_ms = device_ms([lambda s=s: a2j_decode(*s, anchors) for s in sets])
    del sets
    # a flat run that is no whole number of 16-byte words: the element-wise copy
    odd_anchors = torch.randn(50, 2, device=dev, generator=gen) * 40
    for dtype in (torch.float32, torch.bfloat16):
        errs.append(compare(f"K1 N=50 P=7 {dtype}", (*inputs(3, dtype, 50, 7), odd_anchors))[0])
    log("kernels", f"K1 N=50 P=7 B=3 (unaligned runs, element-wise staging) f32 and bf16: "
        f"max|err| {max(errs[-2:]):.3e}")
    # strided views are refused, never copied silently: cls with N innermost,
    # reg with every other channel pair
    c, r, d = inputs(8, torch.float32)
    refused = 0
    for args in ((torch.randn(8, p, n, device=dev, generator=gen).transpose(1, 2), r, d),
                 (c, torch.randn(8, n, p, 4, device=dev, generator=gen)[..., ::2], d)):
        try:
            a2j_decode(*args, anchors)
        except ValueError as exc:
            refused += "must be contiguous" in str(exc)
    if refused != 2:
        raise AssertionError("K1: a strided cls or reg view was not refused")
    log("kernels", "K1 strided cls and reg views: refused with ValueError (no silent copy)")
    kernel, plain = times[torch.bfloat16]
    # bound at the timed shape (B=128, bf16): every input once, the output
    # once; per (image, anchor, joint) a max, a subtraction, an exp and 4
    # multiply-adds, counted as 12 float32 operations. No single PyTorch call
    # computes it.
    b = 128
    moved = 4 * b * n * p * 2 + nbytes(anchors) + b * p * 3 * 4
    result = {"max_abs_err": max(errs), **kernel, "plain_ms": plain["ms"],
              "plain_loop_ms": plain["loop_ms"], "cold_l2_ms": cold_ms,
              **bound(moved, 12 * b * n * p, F32_FLOPS_PER_S), "library_ms": None}
    log("kernels", f"K1 B=128 bf16: bound {result['bound_ms']:.4f} ms ({moved} bytes / 3.35 "
        f"TB/s; by {result['bound_by']}), {result['bound_ms'] / kernel['ms'] * 100:.0f}% of "
        f"it reached on the device; over 4 input sets in turn (cold L2) {cold_ms:.4f} ms; no "
        "library call")
    return result


def gn_kernel_checks(dev, shapes, tag: str) -> dict:
    """K2s and K2a against their plain versions at each ``(h, w, C, G)`` of
    ``shapes``, B = 1, 8 and 128, float32 and bfloat16: K2s to 1e-4 of
    scale with two runs bit-equal, K2a bit for bit with parameters in x's
    type and in float32, ReLU on and off. Times both at every B=128 case,
    and beside them, in bfloat16, the plain versions, ``torch.var_mean``
    and ``F.group_norm`` (+ ``F.relu``). Returns the largest K2s error, the
    number of K2a comparisons and the B=128 bfloat16 times by shape."""
    import torch
    import torch.nn.functional as F

    from handnet_tpu_torch.ops.cuda_gn import (
        gn_apply, gn_apply_reference, gn_group_stats, gn_group_stats_reference, group_norm)

    gen = torch.Generator(device=dev).manual_seed(SEED)
    eps = 1e-5
    stats_errs, applied, b128 = [], 0, {}
    for b in (1, 8, 128):
        for h, w, c, g in shapes:
            scale = torch.rand(c, device=dev, generator=gen) + 0.5
            bias = torch.randn(c, device=dev, generator=gen)
            # statistics of N(2, 3) data; tolerance 1e-4 of their scale (float32
            # reductions of up to 13600 x 16 values in another order)
            x = torch.randn(b, h, w, c, device=dev, generator=gen) * 3 + 2
            for dtype in (torch.float32, torch.bfloat16):
                xd = x.to(dtype)
                name = f"B={b} {h}x{w}x{c} G={g} {dtype}"
                want = gn_group_stats_reference(xd, g)
                tol = 1e-4 * max(1.0, want.abs().max().item())
                stats = same_bits_twice(f"K2s {name}", lambda: gn_group_stats(xd, g))
                stats_errs.append(check(f"K2s {name}", stats, want, tol))
                del want
                # K2a bit for bit: parameters in x's type (as the pipeline holds
                # them) and in float32, with and without the ReLU
                for params in {dtype, torch.float32}:
                    sc, bi = scale.to(params), bias.to(params)
                    for relu in (False, True):
                        got = gn_apply(xd, stats, sc, bi, eps, relu)
                        ref = gn_apply_reference(xd, stats, sc, bi, eps, relu)
                        if got.dtype != xd.dtype or not torch.equal(got, ref):
                            diff = (got.double() - ref.double()).abs()
                            raise AssertionError(
                                f"K2a {name} params {params} relu={relu}: not bit-equal to its "
                                f"plain version ({int((diff > 0).sum())} elements differ, max "
                                f"{diff.max().item():.3e})")
                        applied += 1
                        del got, ref
                line = (f"K2 {name}: K2s max|err| {stats_errs[-1]:.3e} (tol {tol:.1e}), two runs "
                        "bit-equal; K2a bit-equal to its plain version")
                if b == 128:
                    sc, bi = scale.to(dtype), bias.to(dtype)
                    s_t = timed(lambda: gn_group_stats(xd, g))
                    a_t = timed(lambda: gn_apply(xd, stats, sc, bi, eps, True))
                    # K2s: x once, [B, 2, G] float32 out; a subtraction and 2
                    # multiply-adds per element over two passes, counted as 6
                    # float32 operations. K2a: x in, y out; 4 operations per element.
                    s_bound = bound(nbytes(xd) + b * 2 * g * 4, 6 * xd.numel(), F32_FLOPS_PER_S)
                    a_bound = bound(2 * nbytes(xd) + nbytes(stats, sc, bi), 4 * xd.numel(),
                                    F32_FLOPS_PER_S)
                    line += (f"; on the device K2s {s_t['ms']:.4f} ms (bound "
                             f"{s_bound['bound_ms']:.4f}), K2a+ReLU {a_t['ms']:.4f} ms (bound "
                             f"{a_bound['bound_ms']:.4f}); wrapper loops {s_t['loop_ms']:.4f}, "
                             f"{a_t['loop_ms']:.4f} ms")
                    if dtype == torch.bfloat16:
                        grouped = xd.view(b, h * w, g, c // g)
                        xc = xd.permute(0, 3, 1, 2)   # NCHW view of NHWC bytes: channels_last
                        rest = {
                            "K2s plain": timed(lambda: gn_group_stats_reference(xd, g)),
                            "K2a plain": timed(lambda: gn_apply_reference(xd, stats, sc, bi, eps,
                                                                          True)),
                            "torch.var_mean": timed(lambda: torch.var_mean(
                                grouped, dim=(1, 3), correction=0)),
                            "K2s+K2a": timed(lambda: group_norm(xd, sc, bi, g, eps)),
                            "F.group_norm": timed(lambda: F.group_norm(xc, g, sc, bi, eps)),
                            "K2s+K2a+ReLU": timed(lambda: group_norm(xd, sc, bi, g, eps,
                                                                     relu=True)),
                            "F.relu(F.group_norm)": timed(
                                lambda: F.relu(F.group_norm(xc, g, sc, bi, eps))),
                        }
                        line += "; " + ", ".join(f"{k} {v['ms']:.4f} (loop {v['loop_ms']:.4f})"
                                                 for k, v in rest.items())
                        b128[(h, w, c, g)] = {"K2s": s_t, "K2a": a_t, "s_bound": s_bound,
                                              "a_bound": a_bound, **rest}
                log(tag, line)
                del xd, stats
            del x
    return {"err": max(stats_errs), "applied": applied, "b128": b128}


def gn_entry_numbers(t: dict) -> tuple:
    """The JSON numbers of K2s and of K2a at one shape's B=128 bf16 times."""
    pair = {"pair_ms": t["K2s+K2a"]["ms"], "pair_library_ms": t["F.group_norm"]["ms"],
            "pair_relu_ms": t["K2s+K2a+ReLU"]["ms"],
            "pair_relu_library_ms": t["F.relu(F.group_norm)"]["ms"]}
    # the one PyTorch call that computes K2s's function: torch.var_mean; no one
    # call applies given statistics (F.group_norm computes K2s + K2a: pair_*)
    return ({**t["K2s"], "plain_ms": t["K2s plain"]["ms"],
             "plain_loop_ms": t["K2s plain"]["loop_ms"], **t["s_bound"],
             "library_ms": t["torch.var_mean"]["ms"], **pair},
            {**t["K2a"], "plain_ms": t["K2a plain"]["ms"],
             "plain_loop_ms": t["K2a plain"]["loop_ms"], **t["a_bound"], "library_ms": None,
             **pair})


def phase_gn_kernels(dev) -> dict:
    """K2s and K2a against their plain versions at the three FPN levels of
    the fast profile (C=256, G=32), B = 1, 8 and 128, float32 and bfloat16;
    returns the numbers of their JSON entries (times at P3, B=128, bf16)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from handnet_tpu_torch.ops.cuda_gn import gn_group_stats, gn_group_stats_reference, group_norm

    res = gn_kernel_checks(dev, [(h, w, 256, 32) for h, w in GN_LEVELS], "kernels")
    stats_errs = [res["err"]]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    xd = torch.randn(128, 60, 80, 256, device=dev, generator=gen).to(torch.bfloat16)
    sc, bi = torch.ones(256, device=dev), torch.zeros(256, device=dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        group_norm(xd, sc, bi, 32, 1e-5, relu=True)
        torch.cuda.synchronize()
    launched = sorted((key, count) for key, _, count in device_rows(prof))
    if ([c for _, c in launched] != [1, 1] or "gn_apply_kernel" not in launched[0][0]
            or "gn_stats_kernel" not in launched[1][0]):
        raise AssertionError(f"group_norm on the card launched {launched}: "
                             "expected K2s and K2a once each, nothing else")
    del xd
    log("kernels", f"group_norm(relu=True) at P3 B=128 bf16 under the profiler: two kernels, "
        f"{launched[1][0][:60]} and {launched[0][0][:60]}, no other pass over the activation")
    # mean >> std: E[x^2]-E[x]^2 would lose the variance entirely in float32
    x = 1000.0 + 0.1 * torch.randn(8, 60, 80, 256, device=dev, generator=gen)
    got, want = gn_group_stats(x, 32), gn_group_stats_reference(x, 32)
    stats_errs.append(check("K2s mean>>std mean", got[:, 0], want[:, 0], 2e-3))
    rel = ((got[:, 1] - want[:, 1]).abs() / want[:, 1]).max().item()
    if not rel <= 1e-2 or not bool((got[:, 1] > 0).all()):
        raise AssertionError(f"K2s mean>>std: variance rel err {rel:.3e} > 1e-2")
    log("kernels", f"K2s mean>>std (1000 + 0.1 N(0,1)) float32: mean max|err| "
        f"{stats_errs[-1]:.3e} (tol 2e-3), variance max rel err {rel:.3e} (tol 1e-2)")
    log("kernels", f"K2a: {res['applied']} comparisons bit-equal to gn_apply_reference (B=1/8/128 "
        "x P3/P4/P5 x f32/bf16 x parameter type x ReLU on/off)")
    stats_entry, apply_entry = gn_entry_numbers(res["b128"][(60, 80, 256, 32)])
    return {"gn_group_stats": {"max_abs_err": max(stats_errs), **stats_entry},
            "gn_apply": {"max_abs_err": 0.0, **apply_entry}}


def int8_geometries(dev, cfg):
    """Distinct int8 conv geometries of the int8 path at full resolution:
    ``{(h, w, cin, cout, k, stride, pad, dilation, bias): [layer names]}``,
    one name per launch in a call (from hooks on a plain-version run)."""
    import torch

    from handnet_tpu_torch.models.pipeline import HandNetPipeline
    from handnet_tpu_torch.nn.quant import QuantConv

    pipe = HandNetPipeline(cfg, dtype=torch.bfloat16, device=dev, use_kernels=False,
                           seed=SEED)
    geos = {}

    def record(name):
        def hook(m, args):
            _, _, h, w = args[0].shape
            key = (h, w, m.in_channels, m.out_channels, m.kernel_size[0], m.stride[0],
                   m.padding[0], m.dilation[0], m.bias is not None)
            geos.setdefault(key, []).append(name)
        return hook

    hooks = [m.register_forward_pre_hook(record(name)) for name, m in pipe.named_modules()
             if isinstance(m, QuantConv)]
    images, depth, _ = make_frames(1, dev, seed=400)
    pipe(images, depth)
    for h in hooks:
        h.remove()
    return geos


def k3_inputs(geo, batch: int, dtype, per_sample: bool, gen, dev, kind: str = "signed"):
    """Arguments of ``int8_conv`` for one geometry, with random int8 weights
    and scales. Activations: ``signed`` N(0, 2) (as the FPN's inputs),
    ``relu`` the same clipped at 0 (half zeros, as most int8 layers' inputs),
    or ``ties`` float32 values within an ulp of x.5 quantization steps. A
    per-layer scale sits at 0.8 of the amax, so that some values saturate."""
    import torch

    from handnet_tpu_torch.nn.quant import scale_from_amax

    h, w, cin, cout, k, s, p, d, has_bias = geo
    wq = torch.randint(-127, 128, (cout, k, k, cin), device=dev, generator=gen,
                       dtype=torch.int8)
    sw = torch.rand(cout, device=dev, generator=gen) * 1e-3 + 1e-4
    bias = torch.randn(cout, device=dev, generator=gen) if has_bias else None
    if kind == "ties":
        sx = scale_from_amax(torch.tensor(3.0, device=dev))
        steps = torch.randint(-127, 127, (batch, h, w, cin), device=dev, generator=gen)
        x = ((steps.float() + 0.5) * sx).to(dtype)
        return x, wq, sx, sw, bias, (s, s), (p, p), (d, d)
    x = torch.randn(batch, h, w, cin, device=dev, generator=gen) * 2
    x = (x.clamp_min(0) if kind == "relu" else x).to(dtype)
    amax = (x.abs().amax(dim=(1, 2, 3)).float() if per_sample
            else 0.8 * x.abs().amax().float())
    return x, wq, scale_from_amax(amax), sw, bias, (s, s), (p, p), (d, d)


def conv_class(geo) -> str:
    _, _, _, _, k, s, _, d, _ = geo
    return f"{k}x{k} " + (f"dilation {d}" if d > 1 else f"stride {s}")


def phase_quantize_kernel(dev) -> None:
    """K3q bit for bit against its plain version."""
    import torch

    from handnet_tpu_torch.ops.cuda_int8_conv import int8_quantize, quantize_activation

    gen = torch.Generator(device=dev).manual_seed(SEED)
    checked = 0
    for geo in (P3_TOWER, (11, 11, 512, 512, 3, 1, 2, 2, False), (15, 20, 64, 64, 1, 1, 0, 1, False)):
        cases = [(kind, dtype, per_sample) for kind in ("signed", "relu")
                 for dtype in (torch.float32, torch.bfloat16) for per_sample in (False, True)]
        cases.append(("ties", torch.float32, False))
        for kind, dtype, per_sample in cases:
            x, _, sx = k3_inputs(geo, 8, dtype, per_sample, gen, dev, kind=kind)[:3]
            got, want = int8_quantize(x, sx), quantize_activation(x, sx)
            if got.dtype != torch.int8 or not torch.equal(got, want):
                raise AssertionError(f"K3q {geo[:3]} {kind} {dtype} per_sample={per_sample}: "
                                     f"{int((got != want).sum())} elements differ from the "
                                     "plain version")
            checked += 1
    log("kernels", f"K3q int8_quantize: {checked} comparisons bit-equal to quantize_activation "
        "(B=8; f32/bf16 x per-layer/per-sample sx x signed/ReLU inputs, f32 near ties; "
        "60x80x256, 11x11x512, 15x20x64)")


def phase_int8_kernel(dev, geos):
    """K3 (K3q then K3g) bit for bit against its plain version on every
    geometry, and the times of K3q, K3g, both and the plain version at
    B=128; returns the JSON numbers of K3q and K3g (times at the P3 tower
    shape, B=128 bf16, post-ReLU input, per-layer scale)."""
    import torch

    from handnet_tpu_torch.ops.cuda_int8_conv import (
        dequantize, int8_conv, int8_conv_gemm, int8_conv_int32_reference,
        int8_conv_reference, int8_quantize, quantize_activation)

    gen = torch.Generator(device=dev).manual_seed(SEED)
    checked, alone, err = 0, 0, 0.0

    def bitwise(name, args):
        nonlocal checked, err
        got, want = int8_conv(*args), int8_conv_reference(*args)
        if got.shape != want.shape or got.dtype != want.dtype or not torch.equal(got, want):
            diff = (got.double() - want.double()).abs()
            raise AssertionError(f"K3 {name}: not bit-equal to its plain version "
                                 f"({int((diff > 0).sum())} elements differ, max "
                                 f"{diff.max().item():.3e})")
        checked += 1
        err = max(err, (got.double() - want.double()).abs().max().item())

    keys = ("launches", "tops", "gbytes_q", "k3q", "k3g", "k3q_dev", "k3g_dev", "k3", "plain",
            "k3q_bound", "k3g_bound")
    classes, p3 = {}, {}
    for geo, names in sorted(geos.items(), key=lambda kv: kv[1][0]):
        h, w, cin, cout, k, s, p, d, has_bias = geo
        label = (f"{names[0]} x{len(names)}: {h}x{w}x{cin}->{cout} {k}x{k} s{s} p{p} d{d}"
                 f"{' +bias' if has_bias else ''}")
        for dtype in (torch.float32, torch.bfloat16):
            for per_sample in (False, True):
                bitwise(f"{label} B=8 {dtype} per_sample={per_sample}",
                        k3_inputs(geo, 8, dtype, per_sample, gen, dev))
        bitwise(f"{label} B=8 f32 near ties",
                k3_inputs(geo, 8, torch.float32, False, gen, dev, kind="ties"))
        args = k3_inputs(geo, 128, torch.bfloat16, False, gen, dev, kind="relu")
        bitwise(f"{label} B=128 bf16 relu", args)
        if geo == P3_TOWER:
            for dtype, per_sample in ((torch.bfloat16, True), (torch.float32, False),
                                      (torch.float32, True)):
                bitwise(f"{label} B=128 {dtype} per_sample={per_sample}",
                        k3_inputs(geo, 128, dtype, per_sample, gen, dev))
        x, wq, sx, sw, bias, stride, padding, dilation = args
        q = int8_quantize(x, sx)
        gemm = (q, wq, sx, sw, bias, stride, padding, dilation, x.dtype)
        out = int8_conv_gemm(*gemm)
        # each kernel alone against its own plain version, so that a fault in
        # the composition above is attributed
        if not torch.equal(q, quantize_activation(x, sx)):
            raise AssertionError(f"K3q {label} B=128 bf16 relu: not bit-equal to "
                                 "quantize_activation")
        want = dequantize(int8_conv_int32_reference(q, wq, stride, padding, dilation),
                          sx, sw, bias).to(x.dtype)
        if not torch.equal(out, want):
            raise AssertionError(f"K3g {label} B=128 bf16 relu: not bit-equal to the plain "
                                 "int32 conv and dequantize of the same q")
        del want
        alone += 1
        t = {"k3q": cuda_ms(lambda: int8_quantize(x, sx), iters=10, warmup=2),
             "k3g": cuda_ms(lambda: int8_conv_gemm(*gemm), iters=10, warmup=2),
             "k3q_dev": device_ms(lambda: int8_quantize(x, sx), iters=10, warmup=1),
             "k3g_dev": device_ms(lambda: int8_conv_gemm(*gemm), iters=10, warmup=1),
             "k3": cuda_ms(lambda: int8_conv(*args), iters=10, warmup=2),
             "plain": cuda_ms(lambda: int8_conv_reference(*args), iters=10, warmup=2)}
        ops = 2 * out[..., 0].numel() * cout * k * k * cin
        # K3q: x in, q out, 6 float32 operations per element; K3g: q, the
        # weights and the vectors in, the output out, int8 tensor-core ops
        q_bound = bound(nbytes(x, q, sx), 6 * x.numel(), F32_FLOPS_PER_S)
        g_bound = bound(nbytes(q, wq, sx, sw, bias, out), ops, INT8_OPS_PER_S)
        if geo == P3_TOWER:
            p3 = {"k3q": {"ms": t["k3q_dev"], "loop_ms": t["k3q"], **q_bound,
                          "plain_ms": device_ms(lambda: quantize_activation(x, sx), 10, 2)},
                  "k3g": {"ms": t["k3g_dev"], "loop_ms": t["k3g"], **g_bound,
                          "plain_ms": device_ms(lambda: dequantize(int8_conv_int32_reference(
                              q, wq, stride, padding, dilation), sx, sw, bias).to(x.dtype),
                              10, 2)}}
            p3["k3g"].update(k3g_yardsticks(x, q, wq))
        row = classes.setdefault(conv_class(geo), dict.fromkeys(keys, 0.0))
        for key, value in (("launches", 1), ("tops", ops / 1e12),
                           ("gbytes_q", nbytes(x, q) / 1e9), ("k3q_bound", q_bound["bound_ms"]),
                           ("k3g_bound", g_bound["bound_ms"]), *t.items()):
            row[key] += value * len(names)
        del args, x, q, out, gemm
        log("kernels", f"K3 int8_conv {label}: B=8 f32/bf16 x per-layer/per-sample sx, "
            f"B=8 f32 near ties and B=128 bf16 bit-equal; B=128 bf16 post-ReLU input, "
            f"per-layer sx, on the device (wrapper loop): K3q {t['k3q_dev']:.4f} "
            f"({t['k3q']:.4f}) ms (bound {q_bound['bound_ms']:.4f}), K3g {t['k3g_dev']:.4f} "
            f"({t['k3g']:.4f}) ms ({ops / t['k3g_dev'] / 1e9:.1f} TOP/s, bound "
            f"{g_bound['bound_ms']:.4f} by {g_bound['bound_by']}); loops: K3 {t['k3']:.4f} ms, "
            f"plain {t['plain']:.4f} ms")
    total = dict.fromkeys(keys, 0.0)
    for name, row in [*sorted(classes.items()), ("all", total)]:
        if name != "all":
            for key in keys:
                total[key] += row[key]
        log("kernels", f"K3 class {name}: {row['launches']:.0f} launches, {row['tops']:.3f} TOP, "
            f"K3q moves {row['gbytes_q']:.3f} GB; per B=128 call, on the device (wrapper "
            f"loops): K3q {row['k3q_dev']:.3f} ({row['k3q']:.3f}) ms (bound "
            f"{row['k3q_bound']:.3f}), K3g {row['k3g_dev']:.3f} ({row['k3g']:.3f}) ms "
            f"({row['tops'] / row['k3g_dev'] * 1e3:.0f} TOP/s, bound {row['k3g_bound']:.3f}), "
            f"K3q+K3g {row['k3q_dev'] + row['k3g_dev']:.3f} ({row['k3q'] + row['k3g']:.3f}) ms; "
            f"loops: K3 in one call {row['k3']:.3f} ms, plain {row['plain']:.3f} ms")
    log("kernels", f"K3: {len(geos)} geometries, {checked} bit-equal comparisons "
        f"(sums of the per-geometry times above; device = the kernels' own durations, "
        f"loop = 10 wrapper calls between two events); K3q and K3g each alone bit-equal to "
        f"its plain version at B=128 on {alone} geometries")
    for part in p3.values():
        part["max_abs_err"] = err
    p3["k3q"]["library_ms"] = p3["k3g"]["library_ms"] = None
    return p3


def k3g_yardsticks(x, q, wq) -> dict:
    """Two PyTorch calls beside K3g at the P3 tower shape, neither of which
    computes K3g's function and neither of which the port calls:
    ``torch._int_mm`` on ready int8 ``[M, K] x [K, N]`` operands (the GEMM
    alone: no im2col, no epilogue), and ``F.conv2d`` in bf16 channels_last
    (what the fast profile pays for the layer)."""
    import torch
    import torch.nn.functional as F

    b, h, w, c = q.shape
    o, kh, kw, _ = wq.shape
    a = torch.randint(-127, 128, (b * h * w, kh * kw * c), device=q.device, dtype=torch.int8)
    bt = wq.reshape(o, -1).t()
    int_mm = device_ms(lambda: torch._int_mm(a, bt), iters=10, warmup=2)
    del a
    xc = x.permute(0, 3, 1, 2)   # NCHW view of NHWC bytes: channels_last
    wf = wq.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    conv = device_ms(lambda: F.conv2d(xc, wf, padding=1), iters=10, warmup=2)
    log("kernels", f"K3g yardsticks at {h}x{w}x{c}->{o} 3x3 B={b}, on the device: torch._int_mm "
        f"[{b * h * w}, {kh * kw * c}] x [{kh * kw * c}, {o}] int8 {int_mm:.4f} ms (GEMM only); "
        f"F.conv2d bf16 channels_last {conv:.4f} ms (the fast profile's layer)")
    return {"yardstick_int_mm_ms": int_mm, "yardstick_conv2d_bf16_ms": conv}


def phase_encode_host_time(dev, geos) -> None:
    """Host time of the tensor-map encodings of one call's 129 launches at
    B=8 (two maps per launch), through the same encoder the launches use."""
    import torch

    from handnet_tpu_torch.kernels import build
    from handnet_tpu_torch.ops.cuda_int8_conv import im2col_geometry

    lib = build.load_library()
    calls = []
    for (h, w, cin, cout, k, s, p, d, _), names in geos.items():
        geo = im2col_geometry(k, k, (s, s), (p, p), (d, d))
        q = torch.empty((8, h, w, cin), dtype=torch.int8, device=dev)
        wq = torch.empty((cout, k, k, cin), dtype=torch.int8, device=dev)
        calls += [(q, wq, (q.data_ptr(), wq.data_ptr(), 8, h, w, cin, cout, k, k, s, s,
                           *geo.lower, *geo.upper))] * len(names)
    runs = []
    for _ in range(5):
        start = time.perf_counter()
        for _, _, args in calls:
            code = lib.hn_int8_conv_encode_maps(*args)
            if code:
                build.check_launch("hn_int8_conv_encode_maps", code)
        runs.append((time.perf_counter() - start) * 1e3)
    log("kernels", f"K3g tensor maps: {len(calls)} launches' encodings (2 maps each, B=8), "
        f"host clock, ctypes call included: " + ", ".join(f"{r:.3f}" for r in runs)
        + f" ms per call's worth (min {min(runs):.3f})")


def make_frames(batch: int, dev, seed: int):
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    images = torch.rand(batch, 480, 640, 3, device=dev, generator=gen)
    depth = 0.3 + 0.7 * torch.rand(batch, 480, 640, device=dev, generator=gen)
    paras = torch.tensor([[600.0, 600.0, 320.0, 240.0]], device=dev).repeat(batch, 1)
    return images, depth, paras


def check_outputs(out, batch: int, crop: int, joints: int) -> None:
    import torch

    shapes = {"joints_uvd": (batch, joints, 3), "joints_uvd_full": (batch, joints, 3),
              "joints_xyz": (batch, joints, 3), "boxes": (batch, 4),
              "crops": (batch, crop, crop, 1), "found": (batch,), "scores": (batch,),
              "sides": (batch,)}
    for key, shape in shapes.items():
        if tuple(out[key].shape) != shape:
            raise AssertionError(f"{key}: shape {tuple(out[key].shape)} != {shape}")
        if out[key].is_floating_point() and not bool(torch.isfinite(out[key]).all()):
            raise AssertionError(f"{key}: non-finite values")
    if not bool(out["found"].all()):
        raise AssertionError(f"found: {int(out['found'].sum())}/{batch} frames")


def compare_outputs(name: str, got, want, joint_tol: float) -> float:
    """Exact detection/crop outputs, joints within ``joint_tol`` (px / mm)."""
    import torch

    for key in ("found", "sides", "boxes", "crops"):
        g, w = got[key].cpu(), want[key].cpu()
        if not torch.equal(g, w):
            frames = [i for i in range(len(g)) if not torch.equal(g[i], w[i])]
            raise AssertionError(f"{name}: {key} differ on frames {frames}; boxes "
                                 f"{got['boxes'].cpu()[frames].tolist()} vs "
                                 f"{want['boxes'].cpu()[frames].tolist()}")
    err = 0.0
    for key, scale in (("joints_uvd", 1.0), ("joints_uvd_full", 1.0), ("joints_xyz", 10.0)):
        err = max(err, check(f"{name} {key}", got[key].cpu(), want[key].cpu(),
                             joint_tol * scale))
    return err


def expected_launches(calls: int, gn: int, int8: int = 0) -> dict:
    return {"gn_group_stats": gn * calls, "gn_apply": gn * calls, "a2j_decode": calls,
            "int8_quantize": int8 * calls, "int8_conv_gemm": int8 * calls}


def per_call(launches: dict, calls: int) -> dict:
    return {name: count // calls for name, count in launches.items()}


def slice_path(dev, cfg, name: str, gn_per_call: int, requests, tag: str = "slice",
               fused: bool = False) -> dict:
    """One float operating point: bf16 calls of the batch sizes ``requests``
    through the kernels, with the launch counts of K1 (1 per call) and K2s
    and K2a (``gn_per_call`` each) and no K3; then in float32 with TF32 off
    the kernel path against the plain path on the card (batch 8) and
    against the port's CPU run (2 frames). ``fused`` turns on the head's
    fused towers. Returns the launch counts per call."""
    import torch

    from handnet_tpu_torch.models.pipeline import HandNetPipeline

    crop, joints = cfg.pipeline.crop_size, cfg.a2j.num_joints

    def build(**kw):
        pipe = HandNetPipeline(cfg, seed=SEED, **kw)
        pipe.detector.head.fused_towers = fused
        return pipe

    pipe = build(dtype=torch.bfloat16, device=dev)
    frames = [make_frames(bsz, dev, seed=100 + i) for i, bsz in enumerate(requests)]
    torch.cuda.synchronize()

    reset_launch_counts()
    start = time.perf_counter()
    outs = [pipe(*req) for req in frames]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = launch_counts()
    for out, req in zip(outs, frames):
        check_outputs(out, len(req[0]), crop, joints)
    calls = len(requests)
    if launches != expected_launches(calls, gn_per_call):
        raise AssertionError(f"{name}: launch counts {launches} for {calls} calls: expected K2s "
                             f"and K2a {gn_per_call} each and K1 1 per call, no K3")
    log(tag, f"{name} bf16 calls of batch {list(requests)} in {seconds:.3f} s (first calls, "
        f"cuDNN set-up included): all frames found, outputs finite; launches {launches}")
    del pipe, outs, frames

    # float32, TF32 off: the kernel path against the plain path on the card,
    # and against the port's own CPU run (which the CPU tests tie to JAX)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    images, depth, paras = make_frames(8, dev, seed=200)
    out_k = build(device=dev)(images, depth, paras)
    out_p = build(device=dev, use_kernels=False)(images, depth, paras)
    err_plain = compare_outputs(f"{name} kernels vs plain (card, f32)", out_k, out_p, 1e-2)
    log(tag, f"{name} f32 batch 8: kernel path == plain path on found/sides/boxes/crops; "
        f"joints max|err| {err_plain:.3e} (tol 1e-2 px, 1e-1 mm)")
    out_c = build(device="cpu")(images[:2].cpu(), depth[:2].cpu(), paras[:2].cpu())
    err_cpu = compare_outputs(f"{name} card vs CPU (f32)", {k: v[:2] for k, v in out_k.items()},
                              out_c, 5e-2)
    log(tag, f"{name} f32 2 frames: card kernel path == CPU run on found/sides/boxes/crops; "
        f"joints max|err| {err_cpu:.3e} (tol 5e-2 px, 5e-1 mm)")
    torch.backends.cudnn.allow_tf32 = True
    return per_call(launches, calls)


def phase_slice(dev, cfg) -> dict:
    return slice_path(dev, cfg, "fast", GN_LAYERS_PER_CALL, SLICE_REQUESTS)


def counted_wrappers() -> dict:
    """Every kernel's wrapper, by the kernel's name in the JSON line."""
    from handnet_tpu_torch.ops.cuda_a2j import a2j_decode
    from handnet_tpu_torch.ops.cuda_gn import gn_apply, gn_group_stats
    from handnet_tpu_torch.ops.cuda_int8_conv import int8_conv_gemm, int8_quantize

    return {"a2j_decode": a2j_decode, "gn_group_stats": gn_group_stats, "gn_apply": gn_apply,
            "int8_quantize": int8_quantize, "int8_conv_gemm": int8_conv_gemm}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in counted_wrappers().items()}


def reset_launch_counts() -> None:
    for fn in counted_wrappers().values():
        fn.launches = 0


def set_int8_kernel(pipe, on: bool) -> None:
    """Route every QuantConv of ``pipe`` through K3 (True) or its plain
    version (False); K1, K2s and K2a are left as they are."""
    from handnet_tpu_torch.nn.quant import QuantConv

    for m in pipe.modules():
        if isinstance(m, QuantConv):
            m.use_kernel = on


def calibrated_pipeline(dev, cfg, dtype):
    """A quant_static pipeline calibrated on two seeded batches of 8."""
    from handnet_tpu_torch.models.pipeline import HandNetPipeline
    from handnet_tpu_torch.nn.quant import assert_calibrated

    pipe = HandNetPipeline(cfg, dtype=dtype, device=dev, seed=SEED)
    frames = [make_frames(8, dev, seed) for seed in CALIBRATION_SEEDS]
    pipe.calibrate([f[0] for f in frames], [f[1] for f in frames])
    assert_calibrated(pipe)
    return pipe


def phase_quant_slice(dev, cfg, cfg_dynamic):
    """The quant_static slice through K1, K2s, K2a, K3q and K3g; returns the launch
    counts of its requests (the main path's run)."""
    import torch

    from handnet_tpu_torch.models.pipeline import HandNetPipeline

    crop, joints = cfg.pipeline.crop_size, cfg.a2j.num_joints
    start = time.perf_counter()
    pipe = calibrated_pipeline(dev, cfg, torch.bfloat16)
    torch.cuda.synchronize()
    log("slice", f"quant_static bf16: calibrated on 2 x 8 seeded frames in "
        f"{time.perf_counter() - start:.3f} s; {INT8_LAYERS} act_amax set, assert_calibrated "
        "passes")
    requests = [make_frames(bsz, dev, seed=100 + i) for i, bsz in enumerate(SLICE_REQUESTS)]
    torch.cuda.synchronize()

    reset_launch_counts()
    start = time.perf_counter()
    outs = [pipe(*req) for req in requests]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = launch_counts()
    for out, bsz in zip(outs, SLICE_REQUESTS):
        check_outputs(out, bsz, crop, joints)
    calls = len(SLICE_REQUESTS)
    expected = {"a2j_decode": calls, "gn_group_stats": GN_LAYERS_PER_CALL * calls,
                "gn_apply": GN_LAYERS_PER_CALL * calls,
                "int8_quantize": INT8_LAUNCHES_PER_CALL * calls,
                "int8_conv_gemm": INT8_LAUNCHES_PER_CALL * calls}
    if launches != expected:
        raise AssertionError(f"quant_static launch counts {launches}, expected {expected}")
    log("slice", f"quant_static bf16 calls of batch {list(SLICE_REQUESTS)} in {seconds:.3f} s "
        f"(first calls): all frames found, outputs finite; launches {launches}")

    # in the pipeline, K3 against its plain version: every output bit-equal
    set_int8_kernel(pipe, False)
    out_plain = pipe(*requests[0])
    set_int8_kernel(pipe, True)
    for key, value in outs[0].items():
        if not torch.equal(value, out_plain[key]):
            raise AssertionError(f"quant_static bf16: {key} differs between K3 and its "
                                 "plain version")
    log("slice", "quant_static bf16 batch 8: every output bit-equal with K3's plain version "
        "in place of K3")
    del pipe, outs, requests, out_plain

    # float32, TF32 off: K3 against its plain version (bit-equal), the whole
    # kernel path against the plain path, and the card against the CPU
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    images, depth, paras = make_frames(8, dev, seed=200)
    kern = calibrated_pipeline(dev, cfg, torch.float32)
    state = {k: v.cpu() for k, v in kern.state_dict().items()}
    out_k = kern(images, depth, paras)
    set_int8_kernel(kern, False)
    out_k3p = kern(images, depth, paras)
    del kern
    for key, value in out_k.items():
        if not torch.equal(value, out_k3p[key]):
            raise AssertionError(f"quant_static f32: {key} differs between K3 and its "
                                 "plain version")
    plain = HandNetPipeline(cfg, device=dev, use_kernels=False, seed=SEED)
    plain.load_state_dict(state)
    out_p = plain(images, depth, paras)
    del plain
    err_plain = compare_outputs("quant_static kernels vs plain (card, f32)", out_k, out_p,
                                INT8_JOINT_TOL)
    log("slice", f"quant_static f32 batch 8: K3 path == K3-plain path bit for bit; kernel "
        f"path == plain path on found/sides/boxes/crops, joints max|err| {err_plain:.3e} "
        f"(tol {INT8_JOINT_TOL} px, {10 * INT8_JOINT_TOL} mm)")
    cpu = HandNetPipeline(cfg, device="cpu", seed=SEED)
    cpu.load_state_dict(state)
    out_c = cpu(images[:2].cpu(), depth[:2].cpu(), paras[:2].cpu())
    del cpu
    err_cpu = compare_outputs("quant_static card vs CPU (f32)",
                              {k: v[:2] for k, v in out_k.items()}, out_c, INT8_JOINT_TOL)
    log("slice", f"quant_static f32 2 frames: card == CPU run on found/sides/boxes/crops; "
        f"joints max|err| {err_cpu:.3e} (tol {INT8_JOINT_TOL} px, {10 * INT8_JOINT_TOL} mm)")
    torch.backends.cudnn.allow_tf32 = True

    # the dynamic profile: per-sample scales, no calibration
    dyn = HandNetPipeline(cfg_dynamic, dtype=torch.bfloat16, device=dev, seed=SEED)
    reset_launch_counts()
    frames = make_frames(8, dev, seed=600)
    out = dyn(*frames)
    torch.cuda.synchronize()
    check_outputs(out, len(frames[0]), crop, joints)
    counts = launch_counts()
    if (counts["int8_quantize"], counts["int8_conv_gemm"]) != (INT8_LAUNCHES_PER_CALL,) * 2:
        raise AssertionError(f"quant (dynamic): launch counts {counts}")
    log("slice", f"quant (dynamic) bf16 batch 8: all frames found, outputs finite; "
        f"launches {counts}")
    return launches


def phase_geometry_kernels(dev) -> dict:
    """K2s and K2a at the shapes that the parity and fused-tower paths give
    them: the parity FPN levels at C=256, G=32, and the fused towers' C=512,
    G=64 at the fast and the parity levels; returns per kernel the B=128
    bf16 numbers by shape for the JSON line."""
    shapes = ([(h, w, 256, 32) for h, w in PARITY_LEVELS]
              + [(h, w, 512, 64) for h, w in GN_LEVELS + PARITY_LEVELS])
    res = gn_kernel_checks(dev, shapes, "geometries")
    log("geometries", f"K2s at {len(shapes)} new shapes x B=1/8/128 x f32/bf16: max|err| "
        f"{res['err']:.3e} (tol 1e-4 of scale), two runs bit-equal; K2a: {res['applied']} "
        "comparisons bit-equal to gn_apply_reference")
    out = {"gn_group_stats": [], "gn_apply": []}
    for (h, w, c, g), t in res["b128"].items():
        shape = f"B=128 {h}x{w}x{c} G={g} bf16"
        cold = gn_cold_l2_ms(dev, 128, h, w, c, g)
        for name, numbers, cold_ms in zip(out, gn_entry_numbers(t), cold):
            out[name].append({"shape": shape, **numbers, "cold_l2_ms": cold_ms})
            log("geometries", f"{name} {shape}: {numbers['ms']:.4f} ms on the device (loop "
                f"{numbers['loop_ms']:.4f}), bound {numbers['bound_ms']:.4f} ms, "
                f"{numbers['bound_ms'] / numbers['ms'] * 100:.0f}% of it; cold L2 "
                f"{cold_ms:.4f} ms, {numbers['bound_ms'] / cold_ms * 100:.0f}% of the bound; "
                f"plain {numbers['plain_ms']:.4f}; library {numbers['library_ms']}")
    return out


def gn_cold_l2_ms(dev, b: int, h: int, w: int, c: int, g: int) -> tuple:
    """K2s's and K2a(+ReLU)'s device times in bfloat16 with every launch on
    fresh input: distinct input sets in turn, at least two and together
    more than three times the 50 MB L2, so that no launch finds its input
    there from the launch before (a loop on one input keeps the tail of the
    last launch's bytes in the L2)."""
    import torch

    from handnet_tpu_torch.ops.cuda_gn import gn_apply, gn_group_stats

    gen = torch.Generator(device=dev).manual_seed(SEED)
    n_sets = max(2, math.ceil(150e6 / (b * h * w * c * 2)))
    sets = [torch.randn(b, h, w, c, device=dev, generator=gen, dtype=torch.bfloat16)
            for _ in range(n_sets)]
    stats = [gn_group_stats(x, g) for x in sets]
    sc = torch.ones(c, device=dev, dtype=torch.bfloat16)
    bi = torch.zeros(c, device=dev, dtype=torch.bfloat16)
    s_ms = device_ms([lambda x=x: gn_group_stats(x, g) for x in sets])
    a_ms = device_ms([lambda x=x, s=s: gn_apply(x, s, sc, bi, 1e-5, True)
                      for x, s in zip(sets, stats)])
    del sets, stats
    return s_ms, a_ms


def phase_resize(dev) -> dict:
    """``resize_bilinear_matmul`` at the parity geometry, B=128: 480x640 ->
    800x1067, padded to 800x1088, float32. Its time on the device, its
    bytes and FLOPs, and the card's run against the CPU's on 2 frames."""
    import torch

    from handnet_tpu_torch.ops.resize import _matrix_on, resize_bilinear_matmul

    gen = torch.Generator(device=dev).manual_seed(SEED)
    b, (h, w), (oh, ow), (ph, pw) = RESIZE_CASE
    x = torch.randn(b, h, w, 3, device=dev, generator=gen)
    run = lambda: resize_bilinear_matmul(x, oh, ow, padded_hw=(ph, pw))  # noqa: E731
    out = run()
    if tuple(out.shape) != (b, ph, pw, 3) or bool(out[:, :, ow:].any()):
        raise AssertionError(f"resize: shape {tuple(out.shape)} or a non-zero pad")
    want = resize_bilinear_matmul(x[:2].cpu(), oh, ow, padded_hw=(ph, pw))
    tol = 1e-5 * max(1.0, want.abs().max().item())
    err = check("resize card vs CPU (2 frames)", out[:2].cpu(), want, tol)
    t = timed(run)
    # each product alone, and the W product as torch.matmul on the permuted
    # view (which ops/resize.py avoids: cuBLAS then takes a transposed operand)
    mh, mw = _matrix_on(h, oh, ph, x.device), _matrix_on(w, ow, pw, x.device)
    xw = x.permute(0, 1, 3, 2).reshape(b * h * 3, w) @ mw.t()
    parts = {"W product (copy + GEMM)": device_ms(
                 lambda: x.permute(0, 1, 3, 2).reshape(b * h * 3, w) @ mw.t(), 5, 1),
             "H product (batched GEMM)": device_ms(
                 lambda: torch.bmm(mh.expand(b, ph, h), xw.view(b, h, 3 * pw)), 5, 1),
             "W product as matmul of the permuted view": device_ms(
                 lambda: torch.matmul(x.permute(0, 1, 3, 2), mw.t()), 3, 1)}
    del xw
    moved = nbytes(x) + nbytes(out)
    # the two products as computed: along W [B*h*3, w] x [w, pw], then along
    # H [ph, h] x [h, 3*pw] per image
    flops = 2 * b * h * 3 * w * pw + 2 * b * ph * h * 3 * pw
    by_bytes = moved / HBM_BYTES_PER_S * 1e3
    by_flops = flops / F32_FLOPS_PER_S * 1e3
    tf32 = torch.backends.cuda.matmul.allow_tf32
    log("geometries", f"resize_bilinear_matmul B={b} {h}x{w} -> {oh}x{ow} pad {ph}x{pw} f32 "
        f"(torch.backends.cuda.matmul.allow_tf32={tf32}): card vs CPU on 2 frames max|err| "
        f"{err:.3e} (tol {tol:.1e}), pad exactly 0; {t['ms']:.4f} ms on the device (loop "
        f"{t['loop_ms']:.4f}); {moved / 1e9:.3f} GB, {flops / 1e9:.1f} GFLOP; byte bound "
        f"{by_bytes:.4f} ms (the function's bound: {by_bytes / t['ms'] * 100:.1f}% of it), "
        f"the two dense products' FLOPs at 67 TFLOP/s {by_flops:.4f} ms; on the device "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in parts.items()))
    return {"ms": t["ms"], "loop_ms": t["loop_ms"], "bytes": moved, "flops": flops,
            "bound_ms": by_bytes, "dense_flop_ms": by_flops, "allow_tf32": tf32, **parts}


def phase_stem(dev) -> dict:
    """The plain and the space-to-depth stem, same weights: in float32 with
    TF32 off at B=8 to 1e-5 of scale, and in bf16 at B=128 to 1e-2 of
    scale (the CPU test's tolerances), at 480x640 and 800x1088; both timed
    at B=128 bf16."""
    import torch

    from handnet_tpu_torch.nn.resnet import StemConv, init_conv_weights_

    conv = StemConv(3, 64, s2d=True)
    init_conv_weights_(conv, torch.Generator().manual_seed(SEED))
    conv = conv.to(dev, memory_format=torch.channels_last)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    times = {}
    torch.backends.cudnn.allow_tf32 = False
    for h, w in STEM_SIZES:
        outs = {}
        for dtype, batch, rel in ((torch.float32, 8, 1e-5), (torch.bfloat16, 128, 1e-2)):
            c = conv.to(dtype)
            x = torch.randn(batch, 3, h, w, device=dev, generator=gen).to(dtype).contiguous(
                memory_format=torch.channels_last)
            with torch.no_grad():
                for s2d in (True, False):
                    c.s2d = s2d
                    outs[s2d] = c(x)
                ref = outs[False].float()
                tol = rel * max(1.0, ref.abs().max().item())
                err = check(f"stem s2d vs plain {h}x{w} B={batch} {dtype}", outs[True].float(),
                            ref, tol)
                del outs, ref
                outs = {}
                line = (f"stem {h}x{w} B={batch} {dtype}: s2d vs plain max|err| {err:.3e} (tol "
                        f"{tol:.1e})")
                if dtype == torch.bfloat16:
                    for s2d in (False, True):
                        c.s2d = s2d
                        times[(h, w, s2d)] = timed(lambda: c(x))
                    p_t, s_t = times[(h, w, False)], times[(h, w, True)]
                    line += (f"; on the device plain {p_t['ms']:.4f} ms (loop "
                             f"{p_t['loop_ms']:.4f}), s2d {s_t['ms']:.4f} ms (loop "
                             f"{s_t['loop_ms']:.4f})")
            log("geometries", line)
            del x
    torch.backends.cudnn.allow_tf32 = True
    return {f"{h}x{w} {'s2d' if s2d else 'plain'}": t["ms"] for (h, w, s2d), t in times.items()}


def head_outputs_close(name: str, got: dict, want: dict) -> float:
    """Raw detector head outputs within the CPU tests' network tolerance:
    rtol 1e-4 with a floor of 1e-4 of each output's scale."""
    import torch

    worst = 0.0
    for key, w in want.items():
        g, w = got[key].double().cpu(), w.double().cpu()
        if g.shape != w.shape or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{name} {key}: shape or non-finite values")
        excess = ((g - w).abs() - 1e-4 * w.abs()).max().item()
        scale = 1e-4 * max(1.0, w.abs().max().item())
        if excess > scale:
            raise AssertionError(f"{name} {key}: beyond rtol 1e-4 + {scale:.1e}")
        worst = max(worst, (g - w).abs().max().item())
    return worst


def phase_parity_int8(dev, cfg) -> dict:
    """Static int8 on the parity geometry: calibrated on the two seeded
    batches of 8, a batch of 8 and one of 128 with K3q and K3g 129 times
    each per call, and at both batches K3 bit-equal to its plain version in
    the pipeline (at B=128 K3g's im2col maps cover up to 128x200x272 base
    pixels)."""
    import torch

    start = time.perf_counter()
    pipe = calibrated_pipeline(dev, cfg, torch.bfloat16)
    log("geometries", f"parity int8 bf16: calibrated on 2 x 8 seeded frames in "
        f"{time.perf_counter() - start:.3f} s")
    requests = [make_frames(bsz, dev, seed=110 + i) for i, bsz in enumerate((8, 128))]
    reset_launch_counts()
    outs = [pipe(*req) for req in requests]
    torch.cuda.synchronize()
    launches = launch_counts()
    for out, req in zip(outs, requests):
        check_outputs(out, len(req[0]), cfg.pipeline.crop_size, cfg.a2j.num_joints)
    expected = expected_launches(2, GN_LAYERS_PER_CALL, INT8_LAUNCHES_PER_CALL)
    if launches != expected:
        raise AssertionError(f"parity int8 launch counts {launches}, expected {expected}")
    set_int8_kernel(pipe, False)
    for out, req in zip(outs, requests):
        out_plain = pipe(*req)
        for key, value in out.items():
            if not torch.equal(value, out_plain[key]):
                raise AssertionError(f"parity int8 bf16 batch {len(req[0])}: {key} differs "
                                     "between K3 and its plain version")
        del out_plain
    set_int8_kernel(pipe, True)
    log("geometries", f"parity int8 bf16 calls of batch 8 and 128: all frames found, outputs "
        f"finite; launches {launches}; batches 8 and 128: every output bit-equal with K3's "
        "plain version in place of K3")
    return per_call(launches, 2)


def phase_fused_towers(dev, cfg) -> dict:
    """The fused-tower head on the fast profile: in float32 (TF32 off) the
    raw head outputs against the unfused head's (what follows the head is
    the same code either way); then the bf16 path with its launches (K2s
    and K2a 12 per call, at C=512) and the f32 checks of slice_path."""
    import torch

    from handnet_tpu_torch.models.fcos import preprocess
    from handnet_tpu_torch.models.pipeline import HandNetPipeline

    torch.backends.cudnn.allow_tf32 = False
    pipe = HandNetPipeline(cfg, device=dev, seed=SEED)
    images = make_frames(8, dev, seed=210)[0]
    with torch.inference_mode():
        net_in = preprocess(images, cfg.fcos)[0]
        unfused_head = pipe.detector(net_in)
        pipe.detector.head.fused_towers = True
        reset_launch_counts()
        fused_head = pipe.detector(net_in)
        counts = launch_counts()
    head_err = head_outputs_close("fused vs unfused head (f32)", fused_head, unfused_head)
    if counts != {**expected_launches(1, GN_FUSED_PER_CALL), "a2j_decode": 0}:
        raise AssertionError(f"fused towers: launch counts {counts} for one detector call")
    torch.backends.cudnn.allow_tf32 = True
    log("geometries", f"fused towers f32 batch 8: head outputs == unfused head's (max|err| "
        f"{head_err:.3e}, rtol 1e-4 + 1e-4 of scale); detector launches {counts}")
    del pipe
    return slice_path(dev, cfg, "fused towers", GN_FUSED_PER_CALL, (8, 128), "geometries",
                      fused=True)


def separated_slots(scores, gap: float):
    """Slots of sorted ``[B, K]`` scores that are more than ``gap`` from both
    neighbours: a detection that another rounding cannot swap."""
    import torch

    s = scores.double()
    big = torch.full_like(s[:, :1], float("inf"))
    before = torch.cat([big, s[:, :-1] - s[:, 1:]], dim=1)
    after = torch.cat([s[:, :-1] - s[:, 1:], big], dim=1)
    return (before > gap) & (after > gap)


def phase_ext_heads(dev, cfg) -> dict:
    """An ``ext=True`` detector (the fast profile with the 100DOH heads),
    detector-only through ``pipe.detect`` at 480x640, B=8, float32 with TF32
    off: K2s and K2a 24 launches each and no other kernel's, shapes, finite
    values, (dx, dy) of norm 0.1 or 0; held against the
    port's CPU run on 2 frames: scores to 1e-5, and the detections whose
    score stands more than 1e-4 from its neighbours' equal (labels, sides,
    contacts, valid) or close (boxes, dxdymags)."""
    import torch

    from handnet_tpu_torch.models.pipeline import HandNetPipeline

    torch.backends.cudnn.allow_tf32 = False
    images = make_frames(8, dev, seed=220)[0]
    pipe = HandNetPipeline(cfg, device=dev, seed=SEED)
    reset_launch_counts()
    det = pipe.detect(images)
    torch.cuda.synchronize()
    counts = launch_counts()
    if counts != {**expected_launches(1, GN_LAYERS_PER_CALL), "a2j_decode": 0}:
        raise AssertionError(f"ext detect: launch counts {counts}, expected K2s and K2a "
                             f"{GN_LAYERS_PER_CALL} each, no K1 and no K3")
    b, k = len(images), cfg.fcos.max_detections
    if tuple(det["contacts"].shape) != (b, k) or tuple(det["dxdymags"].shape) != (b, k, 3):
        raise AssertionError(f"ext detect: contacts {tuple(det['contacts'].shape)}, dxdymags "
                             f"{tuple(det['dxdymags'].shape)}")
    for key, value in det.items():
        if value.is_floating_point() and not bool(torch.isfinite(value).all()):
            raise AssertionError(f"ext detect: {key} not finite")
    norm = det["dxdymags"][..., 1:].norm(dim=-1)
    if not bool(((norm - 0.1).abs() < 1e-5).logical_or(norm == 0).all()):
        raise AssertionError("ext detect: a (dx, dy) pair of norm other than 0.1 or 0")
    cpu = HandNetPipeline(cfg, device="cpu", seed=SEED).detect(images[:2].cpu())
    card = {key: value[:2].cpu() for key, value in det.items()}
    check("ext detect scores card vs CPU", card["scores"], cpu["scores"], 1e-5)
    keep = separated_slots(cpu["scores"], 1e-4)
    if not bool(keep.any()):
        raise AssertionError("ext detect: no detection stands apart from its neighbours")
    for key in ("labels", "sides", "contacts", "valid"):
        if not torch.equal(card[key][keep], cpu[key][keep]):
            raise AssertionError(f"ext detect card vs CPU: {key} differ on separated slots")
    box_err = check("ext detect boxes", card["boxes"][keep], cpu["boxes"][keep], 1e-2)
    dxdy_err = check("ext detect dxdymags", card["dxdymags"][keep], cpu["dxdymags"][keep], 1e-4)
    torch.backends.cudnn.allow_tf32 = True
    log("geometries", f"ext detect f32 batch 8: contacts {tuple(det['contacts'].shape)}, "
        f"dxdymags {tuple(det['dxdymags'].shape)}, finite, (dx, dy) norms 0.1 or 0; launches "
        f"{counts}; 2 frames against the CPU run: scores within 1e-5, {int(keep.sum())} of "
        f"{keep.numel()} slots separated by > 1e-4 equal in labels/sides/contacts/valid, boxes "
        f"max|err| {box_err:.3e} px (tol 1e-2), dxdymags {dxdy_err:.3e} (tol 1e-4)")
    return counts


def phase_geometries(dev, cfgs) -> dict:
    """The parity and turbo operating points and the FCOS variants: the
    kernels at their new shapes, the resize, the stem, then each path.
    Returns the kernels' new-shape numbers, the resize's, the stem's and
    the launch counts per call of each path."""
    kernel_shapes = phase_geometry_kernels(dev)
    resize = phase_resize(dev)
    stem = phase_stem(dev)
    paths = {
        "parity": slice_path(dev, cfgs["parity"], "parity", GN_LAYERS_PER_CALL, SLICE_REQUESTS,
                             "geometries"),
        "parity_int8": phase_parity_int8(dev, cfgs["parity_int8"]),
        "turbo": slice_path(dev, cfgs["turbo"], "turbo", GN_TURBO_PER_CALL, (8, 128),
                            "geometries"),
        "fused_towers": phase_fused_towers(dev, cfgs["fast"]),
        "ext_detect": phase_ext_heads(dev, cfgs["ext"]),
    }
    return {"kernel_shapes": kernel_shapes, "resize": resize, "stem": stem, "paths": paths}


def phase_throughput(dev, cfg, cfg_quant) -> None:
    """frames/s at B=128 in bf16, in turns: fast with kernels and with the
    plain versions, quant_static with K3 and with K3's plain version."""
    import torch

    from handnet_tpu_torch.models.pipeline import HandNetPipeline

    images, depth, paras = make_frames(128, dev, seed=300)
    fast = {"fast kernels": HandNetPipeline(cfg, dtype=torch.bfloat16, device=dev, seed=SEED),
            "fast plain": HandNetPipeline(cfg, dtype=torch.bfloat16, device=dev,
                                          use_kernels=False, seed=SEED)}
    quant = calibrated_pipeline(dev, cfg_quant, torch.bfloat16)
    fps_in_turns([*((name, pipe, lambda: None) for name, pipe in fast.items()),
                  ("quant_static kernels", quant, lambda: set_int8_kernel(quant, True)),
                  ("quant_static K3 plain", quant, lambda: set_int8_kernel(quant, False))],
                 images, depth, paras, iters=10)
    set_int8_kernel(quant, True)
    log("throughput", f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    stage_split([("fast", fast["fast kernels"]), ("quant_static", quant)], images, depth)
    small = make_frames(8, dev, seed=301)
    for name, pipe in (("fast", fast["fast kernels"]), ("quant_static", quant)):
        for _ in range(3):
            pipe(*small)
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(10):
            pipe(*small)
        torch.cuda.synchronize()
        log("throughput", f"bf16 batch 8, {name} kernels: "
            f"{(time.perf_counter() - start) * 100:.3f} ms per call (host clock, 10 calls)")
    profile_by_kernel("quant_static", quant, images, depth)


def set_kernels(pipe, on: bool) -> None:
    """Every kernel of ``pipe`` on (True) or its plain version (False): the
    towers' GroupNorms (K2s, K2a), the int8 convs (K3q, K3g) and A2J's
    decode (K1); the weights stay as they are."""
    for m in pipe.modules():
        if hasattr(m, "use_kernel"):
            m.use_kernel = on
    pipe.a2j.use_kernels = on


def fps_in_turns(runs, images, depth, paras, iters: int = 5) -> dict:
    """frames/s of each ``(name, pipe, prepare)`` of ``runs`` at the batch of
    ``images``, in the order given and then in reverse (2 warm-up calls,
    ``iters`` timed calls each, host clock around synchronize)."""
    import torch

    fps = {name: [] for name, _, _ in runs}
    for name, pipe, prepare in list(runs) + list(runs)[::-1]:
        prepare()
        for _ in range(2):
            pipe(images, depth, paras)
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(iters):
            pipe(images, depth, paras)
        torch.cuda.synchronize()
        fps[name].append(len(images) * iters / (time.perf_counter() - start))
    for name, vals in fps.items():
        log("throughput", f"bf16 batch {len(images)}, {name}: "
            + ", ".join(f"{v:.2f}" for v in vals) + f" frames/s (mean "
            f"{sum(vals) / len(vals):.2f}; {iters} calls per run, host clock around synchronize)")
    return fps


def phase_geometry_throughput(dev, cfgs) -> None:
    """frames/s at B=128 in bf16 of parity and turbo with kernels and with
    plain versions and of the fast profile with fused and unfused towers,
    each pair in turns, and of parity int8; then the stage split of parity,
    where preprocess is the resize."""
    import torch

    from handnet_tpu_torch.models.pipeline import HandNetPipeline

    images, depth, paras = make_frames(128, dev, seed=310)
    for name in ("parity", "turbo"):
        pipe = HandNetPipeline(cfgs[name], dtype=torch.bfloat16, device=dev, seed=SEED)
        fps_in_turns([(f"{name} kernels", pipe, lambda p=pipe: set_kernels(p, True)),
                      (f"{name} plain", pipe, lambda p=pipe: set_kernels(p, False))],
                     images, depth, paras)
        set_kernels(pipe, True)
        if name == "parity":
            stage_split([("parity", pipe)], images, depth)
        del pipe
    pipe = HandNetPipeline(cfgs["fast"], dtype=torch.bfloat16, device=dev, seed=SEED)
    head = pipe.detector.head
    fps_in_turns([("fast fused towers", pipe, lambda: setattr(head, "fused_towers", True)),
                  ("fast unfused towers", pipe, lambda: setattr(head, "fused_towers", False))],
                 images, depth, paras)
    del pipe, head
    pipe = calibrated_pipeline(dev, cfgs["parity_int8"], torch.bfloat16)
    fps_in_turns([("parity int8 kernels", pipe, lambda: None)], images, depth, paras)
    del pipe
    log("throughput", f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def stage_split(pipes, images, depth) -> None:
    """ms per stage at B=128 bf16 (CUDA events, 5 calls after 2), each
    stage run alone on the previous stage's output, for each ``(name,
    pipe)``; under ``torch.inference_mode()``, as the pipeline's forward
    runs (with autograd on, the stage outputs held here would keep every
    activation of the parity detector alive)."""
    import torch

    from handnet_tpu_torch.models.a2j import a2j_postprocess
    from handnet_tpu_torch.models.fcos import decode_detections

    for name, pipe in pipes:
        with torch.inference_mode():
            det = pipe.detector
            net_in, scale = det.preprocess(images)
            head = det(net_in)
            stage = pipe._detect_and_crop(images, depth)
            heads = pipe.a2j(stage["crops"])
            times = {
                "preprocess": cuda_ms(lambda: det.preprocess(images), 5, 2),
                "detector network": cuda_ms(lambda: det(net_in), 5, 2),
                "decode + NMS": cuda_ms(lambda: decode_detections(
                    head, det.anchors, det.cfg, scale_to_original=scale), 5, 2),
                "A2J network": cuda_ms(lambda: pipe.a2j(stage["crops"]), 5, 2),
                "A2J decode": cuda_ms(lambda: a2j_postprocess(heads, pipe.a2j.anchors), 5, 2),
                "whole forward": cuda_ms(lambda: pipe(images, depth), 5, 2),
            }
        log("throughput", f"stage split, {name} kernels, bf16 B=128 (ms): "
            + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))


def profile_by_kernel(name: str, pipe, images, depth, calls: int = 3) -> None:
    """Device time of ``calls`` B=128 forwards by kernel (torch.profiler),
    and the share of the wall time in which no kernel ran. The table is
    informative (where the profiler records no device time, it says so); a
    failure of the forwards under it is a failure of the script."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    pipe(images, depth)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(calls):
            pipe(images, depth)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    rows = device_rows(prof)
    busy = sum(ms for _, ms, _ in rows)
    if busy <= 0:
        log("throughput", f"profile of {name}: the profiler recorded no device time")
        return
    log("throughput", f"profile of {name}, bf16 B=128, {calls} calls under the profiler: wall "
        f"{wall_ms:.2f} ms, kernels {busy:.2f} ms, no kernel running "
        f"{max(0.0, 1 - busy / wall_ms) * 100:.1f}% of the wall time")
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:14]:
        log("throughput", f"  {ms / calls:8.3f} ms/call {count // calls:5d} launches/call  "
            f"{key[:110]}")


# --- the serving tier: CUDA graphs per bucket, PipelineServer, the artifact ---

SERVE_BUCKETS = (1, 8, 128)
SERVE_FRAMES = 512                # the host-thread-fed run
SERVE_STREAMS = 4
TRICKLE_FRAMES = 16
ARTIFACT_SERVE_FRAMES = 64
ARTIFACT_DIR = "build/serve_artifact"

# Run in a fresh interpreter by the [serve] phase: load the artifact with no
# model code, predict 1 frame (bucket 1), 3 (bucket 8, pad 5 > 3) and 130
# (128 + 2), save them, time a replay of each bucket (the server's fields),
# then serve 64 frames through PipelineServer.from_artifact.
_ARTIFACT_SCRIPT = r"""
import json, sys, threading, time
import numpy as np
import torch

def foreign():
    return sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax",
                  "handnet_tpu") or m.startswith("handnet_tpu_torch.models"))

path, device, seed, n_serve, streams = sys.argv[1], sys.argv[2], int(sys.argv[3]), \
    int(sys.argv[4]), int(sys.argv[5])
start = time.perf_counter()
from handnet_tpu_torch.export import ServingArtifact
from handnet_tpu_torch.ops import cuda_a2j, cuda_gn, cuda_int8_conv
art = ServingArtifact.load(path, device=device)
load_s = time.perf_counter() - start
assert not foreign(), foreign()
counted = {"a2j_decode": cuda_a2j.a2j_decode, "gn_group_stats": cuda_gn.gn_group_stats,
           "gn_apply": cuda_gn.gn_apply, "int8_quantize": cuda_int8_conv.int8_quantize,
           "int8_conv_gemm": cuda_int8_conv.int8_conv_gemm}
h, w = art.frame_hw
rng = np.random.default_rng(seed)
rgb = rng.integers(0, 256, size=(133, h, w, 3), dtype=np.uint8)
depth = rng.integers(300, 1000, size=(133, h, w), dtype=np.uint16)
start = time.perf_counter()
parts = {"one": art.predict(rgb[:1], depth[:1]), "few": art.predict(rgb[:3], depth[:3]),
         "many": art.predict(rgb[3:], depth[3:])}
predict_s = time.perf_counter() - start
np.savez(f"{path}/predicted.npz",
         **{f"{part}/{k}": v for part, out in parts.items() for k, v in out.items()})
launches = {name: fn.launches for name, fn in counted.items()}
captured = list(art.graphs.captured)

from handnet_tpu_torch.apps.serve import DEFAULT_FIELDS, PipelineServer
def sync():
    if art.device.type == "cuda":
        torch.cuda.synchronize(art.device)
replay_ms = {}
for b in art.buckets:
    im, d = torch.from_numpy(rgb[:b]).to(art.device), torch.from_numpy(depth[:b]).to(art.device)
    replay_ms[b] = []
    for _ in range(2):
        for _ in range(2):
            art.graphs.run(b, im, d, fields=DEFAULT_FIELDS)
        sync()
        start = time.perf_counter()
        for _ in range(10):
            art.graphs.run(b, im, d, fields=DEFAULT_FIELDS)
        sync()
        replay_ms[b].append((time.perf_counter() - start) * 1e3 / 10)
assert not any(fn.launches - launches[name] for name, fn in counted.items())
server = PipelineServer.from_artifact(art, flush_timeout=0.002).start()
def feed(sid):
    for fid in range(n_serve // streams):
        server.submit(sid, fid, rgb[(sid + fid) % 8], depth[(sid + fid) % 8])
threads = [threading.Thread(target=feed, args=(s,)) for s in range(streams)]
for t in threads:
    t.start()
got = [server.get(timeout=300) for _ in range(n_serve)]
for t in threads:
    t.join()
server.stop()
ids = sorted((sid, fid) for sid, fid, _ in got)
assert ids == sorted((s, f) for s in range(streams) for f in range(n_serve // streams)), ids
assert not any("error" in out for _, _, out in got), [o for _, _, o in got if "error" in o][:1]
assert all(np.isfinite(out["joints_uvd"]).all() for _, _, out in got)
assert not foreign(), foreign()
print(json.dumps({"load_s": load_s, "predict_s": predict_s, "launches": launches,
                  "replay_ms": replay_ms,
                  "captured": captured, "served": len(got),
                  "bucket_dispatches": server.bucket_dispatches,
                  "sustained_fps": server.sustained_fps, "latency": server.latency_stats()}))
"""


def wire_frames(batch: int, seed: int, hw=(480, 640)):
    """Seeded sensor-format frames: uint8 RGB ``[B, H, W, 3]`` and uint16
    depth in mm ``[B, H, W]`` (numpy)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, size=(batch, *hw, 3), dtype=np.uint8),
            rng.integers(300, 1000, size=(batch, *hw), dtype=np.uint16))


def padded_eager(forward, rgb, depth, bucket: int, dev) -> dict:
    """``forward`` (wire frames on ``dev``) on ``rgb``/``depth`` padded with
    zero frames to ``bucket``, cut back to the real frames, on the host."""
    import numpy as np
    import torch

    n = len(rgb)
    pad = [(0, bucket - n)] + [(0, 0)] * (rgb.ndim - 1)
    im = torch.from_numpy(np.pad(rgb, pad)).to(dev)
    d = torch.from_numpy(np.pad(depth, pad[:-1])).to(dev)
    return {k: v[:n].cpu() for k, v in forward(im, d).items()}


def check_serve_outputs(out: dict, batch: int, crop: int, joints: int,
                        expect_found: bool) -> None:
    """Shapes of the server's fields, finite values, every frame found."""
    import torch

    shapes = {"joints_uvd": (batch, joints, 3), "joints_uvd_full": (batch, joints, 3),
              "boxes": (batch, 4), "crops": (batch, crop, crop, 1), "found": (batch,),
              "scores": (batch,), "sides": (batch,), "verts": (batch, MESH_VERTS, 3)}
    for key, value in out.items():
        if tuple(value.shape) != shapes[key]:
            raise AssertionError(f"{key}: shape {tuple(value.shape)} != {shapes[key]}")
        if value.is_floating_point() and not bool(torch.isfinite(value).all()):
            raise AssertionError(f"{key}: non-finite values")
    if expect_found and not bool(out["found"].all()):
        raise AssertionError(f"found: {int(out['found'].sum())}/{batch} frames")


def assert_equal_outputs(name: str, got: dict, want: dict) -> None:
    import torch

    if sorted(got) != sorted(want):
        raise AssertionError(f"{name}: keys {sorted(got)} vs {sorted(want)}")
    for key in want:
        g, w = torch.as_tensor(got[key]).cpu(), torch.as_tensor(want[key]).cpu()
        if g.shape != w.shape or not torch.equal(g, w):
            raise AssertionError(f"{name}: {key} differs")


def serving_server(cfg, dev, state_dict, buckets, frame_hw):
    from handnet_tpu_torch.apps.serve import PipelineServer

    return PipelineServer(cfg, batch_size=buckets[-1], state_dict=state_dict,
                          frame_hw=frame_hw, dtype=cfg_dtype(dev), batch_buckets=buckets,
                          device=dev)


def cfg_dtype(dev):
    import torch

    return torch.bfloat16 if torch.device(dev).type == "cuda" else torch.float32


def replay_against_eager(name: str, server, gn: int, int8: int, frame_hw, sizes,
                         expect_found: bool) -> dict:
    """Capture every bucket of ``server`` (counting the eager warm-up and
    capture calls' launches), then hold a replay of each of ``sizes``
    against the eager forward of the same bucket, bit for bit; a replay
    launches nothing through the Python wrappers. Returns the launches per
    eager call."""
    import torch

    from handnet_tpu_torch.graphs import WARMUP_CALLS

    cfg, dev = server.cfg, server.device
    crop, joints = cfg.pipeline.crop_size, cfg.a2j.num_joints
    reset_launch_counts()
    start = time.perf_counter()
    server.compile()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - start
    calls = (WARMUP_CALLS + 1) * len(server.batch_buckets) if dev.type == "cuda" else 0
    launches = launch_counts()
    if calls and launches != expected_launches(calls, gn, int8):
        raise AssertionError(f"{name}: launches {launches} in {calls} eager calls of the "
                             f"capture: expected K1 1, K2s/K2a {gn}, K3q/K3g {int8} per call")
    log("serve", f"{name}: captured buckets {list(server.batch_buckets)} in {seconds:.3f} s "
        f"({WARMUP_CALLS} warm-up calls and the capture each); launches {launches} "
        f"in {calls} eager calls")
    for i, bsz in enumerate(sizes):
        rgb, depth = wire_frames(bsz, seed=700 + i, hw=frame_hw)
        im, d = torch.from_numpy(rgb).to(dev), torch.from_numpy(depth).to(dev)
        reset_launch_counts()
        eager = server._pipeline_forward(im, d)
        eager_launches = launch_counts()
        if dev.type == "cuda" and eager_launches != expected_launches(1, gn, int8):
            raise AssertionError(f"{name}: eager call of {bsz}: launches {eager_launches}")
        reset_launch_counts()
        replay = server.graphs.run(bsz, im, d)
        if dev.type == "cuda" and any(launch_counts().values()):
            raise AssertionError(f"{name}: a replay went through the Python wrappers: "
                                 f"{launch_counts()}")
        check_serve_outputs(replay, bsz, crop, joints, expect_found)
        assert_equal_outputs(f"{name} B={bsz} replay vs eager", replay, eager)
        log("serve", f"{name} bf16 B={bsz}: graph replay == eager forward bit for bit on "
            f"{sorted(replay)}; eager launches {eager_launches}, replay launches none "
            "through the wrappers")
    return per_call(launches, calls) if calls else {}


def host_ms_in_turns(name: str, server, sizes, frame_hw, iters: int = 10) -> None:
    """ms per call, host clock around synchronize, of the eager forward and
    of a graph replay (copy in, replay, copy out) at each batch of
    ``sizes``, in turns: eager, replay, replay, eager."""
    import torch

    dev = server.device
    for bsz in sizes:
        rgb, depth = wire_frames(bsz, seed=720, hw=frame_hw)
        im, d = torch.from_numpy(rgb).to(dev), torch.from_numpy(depth).to(dev)
        runs = {"eager": lambda: server._pipeline_forward(im, d),
                "replay": lambda: server.graphs.run(bsz, im, d, fields=server.out_fields)}
        ms = {"eager": [], "replay": []}
        for run in ("eager", "replay", "replay", "eager"):
            for _ in range(2):
                runs[run]()
            torch.cuda.synchronize(dev)
            start = time.perf_counter()
            for _ in range(iters):
                runs[run]()
            torch.cuda.synchronize(dev)
            ms[run].append((time.perf_counter() - start) * 1e3 / iters)
        log("serve", f"{name} bf16 B={bsz}, ms per call (host clock, {iters} calls, in turns "
            f"eager, replay, replay, eager): eager " + ", ".join(f"{v:.3f}" for v in ms["eager"])
            + "; replay " + ", ".join(f"{v:.3f}" for v in ms["replay"]))


def phase_idle_shares(dev, cfg) -> None:
    """The share of the wall time in which no kernel runs, under
    torch.profiler, for the fast forward at B=8 and 128, eager and as a
    CUDA-graph replay. Last of the script: in two runs on the card's machine,
    profiler sessions over graph replays taken in the [serve] phase left the
    one-call session of [kernels] that followed empty."""
    import torch

    from handnet_tpu_torch.graphs import BucketGraphs, dequantize_wire
    from handnet_tpu_torch.models.pipeline import HandNetPipeline

    pipe = HandNetPipeline(cfg, dtype=torch.bfloat16, device=dev, seed=SEED)
    forward = lambda im, d: pipe(*dequantize_wire(im, d))   # noqa: E731
    graphs = BucketGraphs(forward, (480, 640), True, dev)
    for bsz in SERVE_BUCKETS[1:]:
        rgb, depth = wire_frames(bsz, seed=720)
        im, d = torch.from_numpy(rgb).to(dev), torch.from_numpy(depth).to(dev)
        for name, fn in (("eager", lambda: forward(im, d)),
                         ("replay", lambda: graphs.run(bsz, im, d))):
            wall, busy = busy_ms(fn)
            log("throughput", f"fast bf16 B={bsz} {name} under the profiler: wall {wall:.3f} ms "
                f"per call, kernels {busy:.3f} ms, no kernel running "
                f"{max(0.0, 1 - busy / wall) * 100:.1f}% of the wall time" if busy else
                f"fast bf16 B={bsz} {name}: the profiler recorded no device time")


def busy_ms(fn, calls: int = 5) -> tuple:
    """(wall ms, kernel ms) per call of ``fn`` under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - start) * 1e3 / calls
    return wall, sum(ms for _, ms, _ in device_rows(prof)) / calls


def serve_fed(server, frame_hw, n_frames: int, streams: int, expect_found: bool) -> None:
    """``n_frames`` from ``streams`` host threads through the started
    ``server``: every frame comes back once with its ids and no error, and
    the frames of the first full and the first partial dispatch equal the
    eager forward of their padded batch, bit for bit."""
    import threading

    import numpy as np

    cfg = server.cfg
    pool = wire_frames(8, seed=730, hw=frame_hw)
    dispatches = []
    dispatch = server._dispatch

    def recording(items):   # which frames rode together, in which bucket
        out = dispatch(items)
        bucket = next(b for b in server.batch_buckets if b >= len(items))
        dispatches.append(([(sid, fid) for sid, fid, *_ in items], bucket))
        return out

    server._dispatch = recording
    per_stream = n_frames // streams

    def feed(sid):
        for fid in range(per_stream):
            k = (sid + fid) % len(pool[0])
            server.submit(sid, fid, pool[0][k], pool[1][k])

    before = dict(server.bucket_dispatches)
    threads = [threading.Thread(target=feed, args=(s,)) for s in range(streams)]
    start = time.perf_counter()
    for t in threads:
        t.start()
    got = {}
    for _ in range(streams * per_stream):
        sid, fid, out = server.get(timeout=300)
        if (sid, fid) in got:
            raise AssertionError(f"frame {(sid, fid)} came back twice")
        got[(sid, fid)] = out
    seconds = time.perf_counter() - start
    for t in threads:
        t.join()
    del server._dispatch     # the class's method again
    if set(got) != {(s, f) for s in range(streams) for f in range(per_stream)}:
        raise AssertionError(f"served {len(got)} frames, not every one of {n_frames}")
    errors = [out["error"] for out in got.values() if "error" in out]
    if errors:
        raise AssertionError(f"{len(errors)} frames came back with an error: {errors[0]}")
    for (sid, fid), out in got.items():
        if not np.isfinite(out["joints_uvd"]).all() or (expect_found and not out["found"]):
            raise AssertionError(f"frame {(sid, fid)}: non-finite joints or not found")
    checked = []
    for ids, bucket in dispatches:
        if (len(ids) == bucket and "full" not in checked) or (
                len(ids) < bucket and "partial" not in checked):
            ks = [(sid + fid) % len(pool[0]) for sid, fid in ids]
            want = padded_eager(server._pipeline_forward, pool[0][ks], pool[1][ks], bucket,
                                server.device)
            served = {k: np.stack([got[i][k] for i in ids]) for k in server.out_fields}
            assert_equal_outputs(f"dispatch of {len(ids)} in bucket {bucket}", served,
                                 {k: want[k] for k in server.out_fields})
            checked.append("full" if len(ids) == bucket else "partial")
            log("serve", f"a dispatch of {len(ids)} frames in bucket {bucket}: served "
                "results == the eager forward of the padded batch, bit for bit")
    moved = {b: server.bucket_dispatches[b] - before[b] for b in before}
    log("serve", f"served {len(got)} frames from {streams} host threads in {seconds:.3f} s "
        f"({len(got) / seconds:.1f} frames/s client-side): each once with its ids, no error; "
        f"sustained_fps {server.sustained_fps:.1f}; latency_stats {server.latency_stats()}; "
        f"bucket_dispatches of this run {moved}")


def serve_trickle(server, frame_hw, n_frames: int) -> None:
    """Single frames, each submitted after the last result: they ride bucket
    1; their submit->result latencies, client-side."""
    import numpy as np

    rgb, depth = wire_frames(1, seed=740, hw=frame_hw)
    before = server.bucket_dispatches[1]
    lat = []
    for fid in range(n_frames):
        start = time.perf_counter()
        server.submit("trickle", fid, rgb[0], depth[0])
        sid, got_fid, out = server.get(timeout=120)
        lat.append((time.perf_counter() - start) * 1e3)
        if (sid, got_fid) != ("trickle", fid) or "error" in out:
            raise AssertionError(f"trickle frame {fid}: got {(sid, got_fid)} {sorted(out)}")
    if server.bucket_dispatches[1] - before != n_frames:
        raise AssertionError(f"trickle: {server.bucket_dispatches[1] - before} bucket-1 "
                             f"dispatches for {n_frames} frames")
    p50, p99 = np.percentile(lat, [50, 99])
    log("serve", f"trickle of {n_frames} single frames, each after the last result: all rode "
        f"bucket 1; submit->result p50 {p50:.3f} ms, p99 {p99:.3f} ms, max {max(lat):.3f} ms")


def serve_fault(server, frame_hw) -> None:
    """One injected failing dispatch: its frames come back as errors, and
    the server keeps serving."""
    rgb, depth = wire_frames(2, seed=750, hw=frame_hw)
    fwd, state = server._fwd, {"fail": 1}

    def flaky(images, depth_):
        if state["fail"]:
            state["fail"] -= 1
            raise RuntimeError("injected dispatch failure")
        return fwd(images, depth_)

    errors = server.error_count
    server._fwd = flaky
    try:
        server.submit("fault", 0, rgb[0], depth[0])
        sid, fid, out = server.get(timeout=120)
        if "injected dispatch failure" not in out.get("error", ""):
            raise AssertionError(f"fault: frame {(sid, fid)} came back as {sorted(out)}")
        server.submit("fault", 1, rgb[1], depth[1])
        sid, fid, out = server.get(timeout=120)
        if fid != 1 or "error" in out:
            raise AssertionError(f"fault: the next frame came back as {sorted(out)}")
    finally:
        del server._fwd      # the class's method again
    if server.error_count != errors + 1:
        raise AssertionError(f"fault: error_count {server.error_count}, expected {errors + 1}")
    log("serve", "an injected failing dispatch came back as an error result for its frame; "
        "the next frame was served")


def serve_artifact(pipe, cfg, dev, frame_hw, buckets) -> dict:
    """Export the calibrated static-int8 pipeline (quantized wire), load it
    in a fresh interpreter that imports neither jax, the JAX package nor
    ``handnet_tpu_torch.models``, and hold its ``predict`` (1 frame into
    bucket 1, 3 into bucket 8, 130 = 128 + 2) against the live pipeline at
    the same buckets, bit for bit; that interpreter times a replay of each
    bucket and then serves frames through ``PipelineServer.from_artifact``.
    Returns its launches per eager call."""
    import os
    import shutil

    import numpy as np
    import torch

    from handnet_tpu_torch.export import export_pipeline
    from handnet_tpu_torch.graphs import WARMUP_CALLS, dequantize_wire

    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), ARTIFACT_DIR)
    shutil.rmtree(out_dir, ignore_errors=True)
    start = time.perf_counter()
    export_pipeline(cfg, pipe.state_dict(), out_dir, buckets=buckets, frame_hw=frame_hw,
                    dtype=cfg_dtype(dev), quantized_wire=True, device=dev)
    export_s = time.perf_counter() - start
    sizes = {name: os.path.getsize(os.path.join(out_dir, "graphs", name))
             for name in sorted(os.listdir(os.path.join(out_dir, "graphs")))}
    log("serve", f"exported quant_static (quantized wire, buckets {list(buckets)}) in "
        f"{export_s:.2f} s: graphs {sizes} bytes, weights "
        f"{os.path.getsize(os.path.join(out_dir, 'weights.npz'))} bytes")

    seed = 760
    rgb, depth = wire_frames(133, seed, hw=frame_hw)

    def live(frames, deps):
        forward = lambda im, d: pipe(*dequantize_wire(im, d))   # noqa: E731
        top, parts = buckets[-1], []
        for s in range(0, len(frames), top):
            n = len(frames[s:s + top])
            bucket = next(b for b in buckets if b >= n)
            parts.append(padded_eager(forward, frames[s:s + top], deps[s:s + top], bucket, dev))
        return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}

    want = {"one": live(rgb[:1], depth[:1]), "few": live(rgb[:3], depth[:3]),
            "many": live(rgb[3:], depth[3:])}
    free_device_memory(dev)
    env = {**os.environ, "PYTHONPATH": os.path.dirname(os.path.abspath(__file__))}
    start = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", _ARTIFACT_SCRIPT, out_dir, str(dev), str(seed),
                           str(ARTIFACT_SERVE_FRAMES), str(SERVE_STREAMS)],
                          capture_output=True, text=True, env=env, timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"artifact interpreter failed ({proc.returncode}):\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    with np.load(os.path.join(out_dir, "predicted.npz")) as data:
        for part in want:
            got = {k.split("/", 1)[1]: data[k] for k in data.files if k.startswith(part + "/")}
            assert_equal_outputs(f"artifact predict ({part})", got, want[part])
    log("serve", f"a fresh interpreter (no jax, no handnet_tpu, no handnet_tpu_torch.models) "
        f"ran {time.perf_counter() - start:.2f} s: load {report['load_s']:.2f} s, predict of "
        f"1 + 3 + 130 frames {report['predict_s']:.2f} s (graphs captured for buckets "
        f"{report['captured']}) == the live pipeline at the same buckets, bit for bit, pad > n "
        f"and chunking included; ms per replay (host clock, 10 calls, twice, the server's "
        f"fields): "
        + "; ".join(f"B={b} " + ", ".join(f"{v:.3f}" for v in ms)
                    for b, ms in report["replay_ms"].items())
        + f"; from_artifact served {report['served']} frames, each once, "
        f"no error, {report['sustained_fps']:.1f} sustained fps, latency {report['latency']}, "
        f"bucket_dispatches {report['bucket_dispatches']}")
    if dev.type != "cuda":
        return {}
    calls = (WARMUP_CALLS + 1) * len(report["captured"])
    if report["launches"] != expected_launches(calls, GN_LAYERS_PER_CALL, INT8_LAUNCHES_PER_CALL):
        raise AssertionError(f"artifact: launches {report['launches']} in {calls} eager calls")
    return per_call(report["launches"], calls)


def phase_serve(dev, cfg_fast, cfg_quant, frame_hw=(480, 640), buckets=SERVE_BUCKETS,
                n_frames: int = SERVE_FRAMES, expect_found: bool = True) -> dict:
    """The serving tier at full width: CUDA graph replays against the eager
    forward (fast and calibrated quant_static, every bucket), a fast server
    fed by host threads, a trickle, host ms per call eager against replay
    (fast and quant_static, every bucket), fault isolation, and the
    static-int8 artifact in a fresh interpreter. Returns the launches per
    eager call of each serving path."""
    from handnet_tpu_torch.models.pipeline import HandNetPipeline

    paths = {}
    fast = serving_server(cfg_fast, dev, HandNetPipeline(cfg_fast, dtype=cfg_dtype(dev),
                                                         device=dev, seed=SEED).state_dict(),
                          buckets, frame_hw)
    paths["serve fast"] = replay_against_eager("fast", fast, GN_LAYERS_PER_CALL, 0, frame_hw,
                                               buckets, expect_found)
    log("serve", f"compute_fps_probe (B={buckets[-1]} pre-staged on the device, 2 in flight): "
        f"{fast.compute_fps_probe():.1f} frames/s")
    fast.start()
    try:
        serve_fed(fast, frame_hw, n_frames, SERVE_STREAMS, expect_found)
        serve_trickle(fast, frame_hw, TRICKLE_FRAMES)
        serve_fault(fast, frame_hw)
    finally:
        fast.stop()
    log("serve", f"bucket_dispatches of the fast server {fast.bucket_dispatches}, error_count "
        f"{fast.error_count}")
    if dev.type == "cuda":
        host_ms_in_turns("fast", fast, buckets, frame_hw)
    del fast
    free_device_memory(dev)

    pipe = calibrated_pipeline(dev, cfg_quant, cfg_dtype(dev))
    quant = serving_server(cfg_quant, dev, pipe.state_dict(), buckets, frame_hw)
    paths["serve quant_static"] = replay_against_eager("quant_static", quant,
                                                      GN_LAYERS_PER_CALL,
                                                      INT8_LAUNCHES_PER_CALL, frame_hw,
                                                      buckets, expect_found)
    if dev.type == "cuda":
        host_ms_in_turns("quant_static", quant, buckets, frame_hw)
    del quant
    free_device_memory(dev)
    paths["artifact quant_static"] = serve_artifact(pipe, cfg_quant, dev, frame_hw, buckets)
    del pipe
    free_device_memory(dev)
    return paths


def free_device_memory(dev) -> None:
    """Collect the objects dropped so far (a server and its graphs refer to
    each other, so only the collector frees them, graph memory pools
    included) and return the cached blocks to the card."""
    import gc

    import torch

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


# --- the mesh head: pipeline.with_mesh, served, exported; the MANO layer ---

def check_mesh_outputs(name: str, out: dict, batch: int) -> None:
    """verts (and verts_xyz where paras were given): shape, finite, not
    all zero on found frames."""
    import torch

    for key in ("verts", "verts_xyz"):
        if key not in out:
            continue
        value = out[key]
        if tuple(value.shape) != (batch, MESH_VERTS, 3) or value.dtype != torch.float32:
            raise AssertionError(f"{name}: {key} {tuple(value.shape)} {value.dtype}")
        if not bool(torch.isfinite(value).all()) or not bool(value.abs().amax(dim=(1, 2)).gt(0)
                                                             .eq(out["found"]).all()):
            raise AssertionError(f"{name}: {key} non-finite, or zero on a found frame")


def compare_verts(name: str, got: dict, want: dict, share: float, joint_tol: float) -> tuple:
    """verts within ``share`` of their scale, verts_xyz within 1000x that
    plus 10x ``joint_tol`` mm (the wrist's XYZ anchors them); returns the
    errors (m, mm) and the verts' scale."""
    scale = want["verts"].abs().max().item()
    err = check(f"{name} verts", got["verts"].cpu(), want["verts"].cpu(), share * scale)
    err_xyz = check(f"{name} verts_xyz", got["verts_xyz"].cpu(), want["verts_xyz"].cpu(),
                    1000 * share * scale + 10 * joint_tol)
    return err, err_xyz, scale


def mesh_head_work(pipe, joints):
    """The head as the pipeline runs it (normalize, Pose2Mesh, vertex order)
    on ``joints``, as a callable; and its (FLOPs, bytes): the products'
    FLOPs as ``torch.utils.flop_counter`` counts them, and the bytes of
    the joints read, every weight and buffer of the head read once and the
    float32 verts written."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from handnet_tpu_torch.models.pose2mesh import normalize_joints_for_pose2mesh_batched

    def head():
        with torch.inference_mode():
            mesh, _ = pipe.pose2mesh(normalize_joints_for_pose2mesh_batched(joints[..., :2]))
            return mesh[:, pipe.mesh_order].float()

    with FlopCounterMode(display=False) as counter:
        verts = head()
    n_bytes = (nbytes(joints, verts) + nbytes(*pipe.pose2mesh.parameters())
               + nbytes(*pipe.pose2mesh.buffers()) + nbytes(pipe.mesh_order))
    return head, counter.get_total_flops(), n_bytes


def mesh_artifact(pipe, cfg, dev, bucket: int = 8) -> dict:
    """Export the bf16 with_mesh pipeline (quantized wire, every field) at
    one bucket, load it here and hold its ``predict`` against the live
    pipeline's eager forward of the same frames, bit for bit. Returns its
    launches per eager call (the graph's warm-up and capture)."""
    import os
    import shutil

    from handnet_tpu_torch.export import ServingArtifact, export_pipeline
    from handnet_tpu_torch.graphs import WARMUP_CALLS, dequantize_wire

    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "mesh_artifact")
    shutil.rmtree(out_dir, ignore_errors=True)
    start = time.perf_counter()
    export_pipeline(cfg, pipe.state_dict(), out_dir, buckets=(bucket,), dtype=cfg_dtype(dev),
                    quantized_wire=True, device=dev)
    export_s = time.perf_counter() - start
    start = time.perf_counter()
    art = ServingArtifact.load(out_dir, device=dev)
    load_s = time.perf_counter() - start
    if not (art.with_mesh and art.manifest["config"]["pipeline"]["with_mesh"]):
        raise AssertionError("mesh artifact: the manifest does not record the head")
    rgb, depth = wire_frames(bucket, seed=800)
    reset_launch_counts()
    got = art.predict(rgb, depth)
    launches = launch_counts()
    want = padded_eager(lambda im, d: pipe(*dequantize_wire(im, d)), rgb, depth, bucket, dev)
    assert_equal_outputs(f"mesh artifact predict (B={bucket})", got, want)
    calls = WARMUP_CALLS + 1
    if launches != expected_launches(calls, GN_LAYERS_PER_CALL):
        raise AssertionError(f"mesh artifact: launches {launches} in {calls} eager calls")
    size = sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(out_dir) for f in fs)
    log("mesh", f"artifact (bucket {bucket}, quantized wire, every field): export {export_s:.2f} "
        f"s, load {load_s:.2f} s, {size / 1e6:.1f} MB; predict of {bucket} frames == the live "
        f"eager forward bit for bit on {sorted(got)}; launches {launches} in {calls} eager "
        "calls (warm-up and capture)")
    del art
    shutil.rmtree(out_dir, ignore_errors=True)
    return per_call(launches, calls)


def phase_mesh(dev, cfg, cfg_quant) -> dict:
    """The fast operating point with the mesh head (``pipeline.with_mesh``)
    at full width: bf16 calls through the kernels with their launch counts;
    the head's stage time against its bound; frames/s with and without the
    head in turns; graph replays == eager and ``"verts"`` served; the
    artifact; the f32 kernel path against the plain path and the CPU; one
    calibrated quant_static batch; the MANO layer. Returns the launches per
    call of each mesh path."""
    import numpy as np
    import torch

    from handnet_tpu_torch.apps.serve import DEFAULT_FIELDS, PipelineServer
    from handnet_tpu_torch.models.mano import ManoAssets, ManoLayer
    from handnet_tpu_torch.models.pipeline import HandNetPipeline
    from handnet_tpu_torch.models.pose2mesh import normalize_joints_for_pose2mesh_batched

    paths = {}
    crop, joints = cfg.pipeline.crop_size, cfg.a2j.num_joints
    start = time.perf_counter()
    pipe = HandNetPipeline(cfg, dtype=torch.bfloat16, device=dev, seed=SEED)
    sizes = pipe.pyramid.mesh_sizes
    log("mesh", f"with_mesh pipeline (PoseNet {cfg.pose2mesh.posenet_hid} x "
        f"{cfg.pose2mesh.posenet_stages} stages, Chebyshev order {cfg.pose2mesh.cheby_order}, "
        f"strip stand-in pyramid {list(sizes)} nodes) built in {time.perf_counter() - start:.2f} "
        f"s; head parameters {sum(p.numel() for p in pipe.pose2mesh.parameters())}")
    frames = [make_frames(bsz, dev, seed=100 + i) for i, bsz in enumerate(MESH_REQUESTS)]
    torch.cuda.synchronize()
    reset_launch_counts()
    start = time.perf_counter()
    outs = [pipe(*req) for req in frames]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = launch_counts()
    for out, bsz in zip(outs, MESH_REQUESTS):
        check_outputs(out, bsz, crop, joints)
        check_mesh_outputs("mesh bf16", out, bsz)
    calls = len(MESH_REQUESTS)
    if launches != expected_launches(calls, GN_LAYERS_PER_CALL):
        raise AssertionError(f"mesh: launch counts {launches} for {calls} calls: expected K2s "
                             f"and K2a {GN_LAYERS_PER_CALL} each and K1 1 per call, no K3")
    paths["mesh"] = per_call(launches, calls)
    log("mesh", f"bf16 calls of batch {list(MESH_REQUESTS)} in {seconds:.3f} s (first calls): "
        f"all frames found, verts [B, {MESH_VERTS}, 3] and verts_xyz finite, non-zero; launches "
        f"{launches}")

    # the head alone at B=128: its time against its bound, its kernels
    head, flops, n_bytes = mesh_head_work(pipe, outs[-1]["joints_uvd"])
    head_bound = bound(n_bytes, flops, BF16_FLOPS_PER_S)
    head_t = timed(head)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            head()
        torch.cuda.synchronize()
    rows = device_rows(prof)
    per_call_launches = sum(n for _, _, n in rows) / 3
    log("mesh", f"head (normalize + Pose2Mesh + vertex order), bf16 B={MESH_REQUESTS[-1]}: "
        f"{head_t['ms']:.4f} ms on the device, {head_t['loop_ms']:.4f} ms loop; bound "
        f"{head_bound['bound_ms']:.4f} ms by {head_bound['bound_by']} ({flops / 1e9:.1f} GFLOP "
        f"at {BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s, {n_bytes / 1e6:.1f} MB at 3.35 TB/s), "
        f"{head_bound['bound_ms'] / head_t['ms'] * 100:.1f}% of it; "
        f"{per_call_launches:.1f} kernel launches per call (profiler, 3 calls)")
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:6]:
        log("mesh", f"  {ms / 3:8.4f} ms/call {count / 3:6.1f} launches/call  {key[:100]}")

    # frames/s at B=128 with and without the head, in turns
    the_head = pipe.pose2mesh
    # the same pipeline without its head: pose2mesh None skips it
    fps = fps_in_turns([("fast + mesh head", pipe, lambda: setattr(pipe, "pose2mesh", the_head)),
                        ("fast, no head", pipe, lambda: setattr(pipe, "pose2mesh", None))],
                       *frames[-1], iters=10)
    pipe.pose2mesh = the_head
    with_head, without = (sum(v) / len(v) for v in fps.values())
    log("mesh", f"the head costs {(1 - with_head / without) * 100:.2f}% of fast's frames/s at "
        f"B={MESH_REQUESTS[-1]} bf16 ({with_head:.2f} vs {without:.2f}, means of the turns)")
    del outs, frames, head
    free_device_memory(dev)

    # CUDA graphs: replay == eager at B=8 and 128; "verts" served
    server = PipelineServer(cfg, batch_size=128, state_dict=pipe.state_dict(),
                            frame_hw=(480, 640), dtype=torch.bfloat16, batch_buckets=(8, 128),
                            out_fields=DEFAULT_FIELDS + ("verts",), device=dev)
    paths["serve mesh"] = replay_against_eager("mesh", server, GN_LAYERS_PER_CALL, 0,
                                               (480, 640), (8, 128), True)
    server.start()
    try:
        serve_fed(server, (480, 640), 32, 2, True)
    finally:
        server.stop()
    log("mesh", f"the server streamed {sorted(server.out_fields)}: bucket_dispatches "
        f"{server.bucket_dispatches}, error_count {server.error_count}")
    del server
    free_device_memory(dev)
    paths["artifact mesh"] = mesh_artifact(pipe, cfg, dev)
    del pipe
    free_device_memory(dev)

    # float32, TF32 off: the kernel path against the plain path and the CPU
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    images, depth, paras = make_frames(8, dev, seed=200)
    kern = HandNetPipeline(cfg, device=dev, seed=SEED)
    out_k = kern(images, depth, paras)
    out_p = HandNetPipeline(cfg, device=dev, seed=SEED, use_kernels=False)(images, depth, paras)
    check_mesh_outputs("mesh f32", out_k, 8)
    err_j = compare_outputs("mesh kernels vs plain (card, f32)", out_k, out_p, 1e-2)
    err_v = compare_verts("mesh kernels vs plain (card, f32)", out_k, out_p, MESH_TOL_PLAIN, 1e-2)
    log("mesh", f"f32 batch 8: kernel path == plain path on found/sides/boxes/crops; joints "
        f"max|err| {err_j:.3e}; verts max|err| {err_v[0]:.3e} m (scale {err_v[2]:.3e}, tol "
        f"{MESH_TOL_PLAIN} of it), verts_xyz {err_v[1]:.3e} mm")
    cpu = HandNetPipeline(cfg, device="cpu", seed=SEED)
    out_c = cpu(images[:2].cpu(), depth[:2].cpu(), paras[:2].cpu())
    first2 = {k: v[:2] for k, v in out_k.items()}
    err_j = compare_outputs("mesh card vs CPU (f32)", first2, out_c, 5e-2)
    err_v = compare_verts("mesh card vs CPU (f32)", first2, out_c, MESH_TOL_CPU, 5e-2)
    # the head alone on the same joints: the card's f32 head against the CPU's
    with torch.inference_mode():
        uv = out_k["joints_uvd"][:2, :, :2]
        head_k = kern.pose2mesh(normalize_joints_for_pose2mesh_batched(uv))[0]
        head_c = cpu.pose2mesh(normalize_joints_for_pose2mesh_batched(uv.cpu()))[0]
    scale = head_c.abs().max().item()
    err_h = check("mesh head card vs CPU (f32, same joints)", head_k.cpu(), head_c,
                  MESH_HEAD_TOL * scale)
    log("mesh", f"f32 2 frames: card == CPU on found/sides/boxes/crops; joints max|err| "
        f"{err_j:.3e}; verts {err_v[0]:.3e} m (tol {MESH_TOL_CPU} of {err_v[2]:.3e}), verts_xyz "
        f"{err_v[1]:.3e} mm; the head alone on the same joints {err_h:.3e} (tol "
        f"{MESH_HEAD_TOL} of {scale:.3e})")
    torch.backends.cudnn.allow_tf32 = True
    del kern, cpu, out_k, out_p, out_c, first2
    free_device_memory(dev)

    # one calibrated quant_static batch of 8 through K3q/K3g
    quant = calibrated_pipeline(dev, cfg_quant, torch.bfloat16)
    req = make_frames(8, dev, seed=600)
    reset_launch_counts()
    out = quant(*req)
    torch.cuda.synchronize()
    counts = launch_counts()
    check_outputs(out, 8, crop, joints)
    check_mesh_outputs("mesh quant_static", out, 8)
    if counts != expected_launches(1, GN_LAYERS_PER_CALL, INT8_LAUNCHES_PER_CALL):
        raise AssertionError(f"mesh quant_static: launch counts {counts}")
    paths["mesh quant_static"] = counts
    log("mesh", f"quant_static bf16 batch 8 (calibrated; the head stays bf16): all frames "
        f"found, verts finite; launches {counts}")
    del quant, out, req
    free_device_memory(dev)

    # the MANO layer at B=128, f32, against its CPU run
    torch.backends.cuda.matmul.allow_tf32 = False
    assets = ManoAssets.synthetic(np.random.default_rng(SEED))
    rng = np.random.default_rng(810)
    args = [torch.from_numpy(a.astype(np.float32)) for a in (
        rng.normal(size=(128, 48)) * 0.5, rng.normal(size=(128, 10)), rng.normal(size=(128, 3)))]
    mano = ManoLayer(assets, device=dev)
    verts, joints3d = mano(*(a.to(dev) for a in args))
    verts_c, joints_c = ManoLayer(assets, device="cpu")(*args)
    err_v = check("MANO verts card vs CPU", verts.cpu(), verts_c,
                  1e-5 * verts_c.abs().max().item())
    err_j = check("MANO joints card vs CPU", joints3d.cpu(), joints_c,
                  1e-5 * joints_c.abs().max().item())
    dev_args = [a.to(dev) for a in args]
    mano_t = timed(lambda: mano(*dev_args))
    log("mesh", f"ManoLayer f32 B=128 on ManoAssets.synthetic: card == CPU run, verts max|err| "
        f"{err_v:.3e} mm, joints {err_j:.3e} mm (tol 1e-5 of their scale); {mano_t['ms']:.4f} ms "
        f"on the device, {mano_t['loop_ms']:.4f} ms loop")
    return paths


# --- training: FCOSTrainer at the full width of the 100DOH training run ---

def train_batch(dev, cfg, seed: int) -> dict:
    """``TRAIN_BATCH`` seeded 480x640 frames, each with 1-4 boxes (labels 1
    or 2, box_info = contact 0-4, side 0-1, magnitude, dx, dy), padded to
    ``TRAIN_MAX_BOXES`` as the data source pads (label 0, box_info -1 with
    field 4 zeroed), then through the port's ``preprocess`` to the
    detector's input, the boxes scaled as apps/train_fcos.py:136-150 scales
    them."""
    import numpy as np
    import torch

    from handnet_tpu_torch.models.fcos import preprocess

    rng = np.random.default_rng(seed)
    h, w = TRAIN_FRAME
    m = TRAIN_MAX_BOXES
    boxes = np.zeros((TRAIN_BATCH, m, 4), np.float32)
    labels = np.zeros((TRAIN_BATCH, m), np.int32)
    valid = np.zeros((TRAIN_BATCH, m), bool)
    info = np.full((TRAIN_BATCH, m, 5), -1.0, np.float32)
    info[..., 4] = 0.0
    for i in range(TRAIN_BATCH):
        n = int(rng.integers(1, 5))
        for j in range(n):
            bw, bh = rng.uniform(0.05, 0.6) * w, rng.uniform(0.05, 0.6) * h
            x1, y1 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
            boxes[i, j] = [x1, y1, x1 + bw, y1 + bh]
            labels[i, j] = rng.integers(1, 3)
            info[i, j] = [rng.integers(0, 5), rng.integers(0, 2), rng.uniform(0, 1),
                          rng.uniform(-1, 1), rng.uniform(-1, 1)]
        valid[i, :n] = True
    frames = torch.from_numpy(rng.uniform(size=(TRAIN_BATCH, h, w, 3)).astype(np.float32))
    image, _ = preprocess(frames.to(dev), cfg)
    scale = min(cfg.image_h / h, cfg.image_w / w)
    targets = {"boxes": boxes * scale, "labels": labels, "valid": valid, "box_info": info}
    return {"image": image, "targets": {k: torch.from_numpy(v).to(dev)
                                        for k, v in targets.items()}}


def set_gn_kernels(model, on: bool) -> None:
    """The towers' GroupNorms through K2s/K2a (True) or their plain versions."""
    for mod in model.modules():
        if hasattr(mod, "use_kernel"):
            mod.use_kernel = on


def gn_train_gradient(dev) -> None:
    """GroupNorm + ReLU at the P3 train shape, float32 and bf16: K2s and K2a
    (one launch each) with the registered backward against autograd through
    the plain versions, on dx, dscale and dbias. Elements whose ReLU mask
    differs between the two outputs (the statistics differ in the last
    bits) are counted and left out of dx."""
    import torch

    from handnet_tpu_torch.ops.cuda_gn import group_norm, group_norm_reference

    gen = torch.Generator(device=dev).manual_seed(SEED)
    b, h, w, c = GN_TRAIN_SHAPE
    x = torch.randn(b, h, w, c, device=dev, generator=gen) * 3 + 2
    scale = torch.rand(c, device=dev, generator=gen) + 0.5
    bias = torch.randn(c, device=dev, generator=gen)
    dy = torch.randn(b, h, w, c, device=dev, generator=gen)
    for dtype in (torch.float32, torch.bfloat16):
        def grads(fn):
            xs = x.to(dtype).requires_grad_()
            sc, bi = scale.clone().requires_grad_(), bias.clone().requires_grad_()
            y = fn(xs, sc, bi)
            return (y.detach(), *torch.autograd.grad(y, (xs, sc, bi), dy.to(dtype)))

        reset_launch_counts()
        got = grads(lambda a, s, t: group_norm(a, s, t, 32, relu=True))
        counts = launch_counts()
        if (counts["gn_group_stats"], counts["gn_apply"]) != (1, 1):
            raise AssertionError(f"GroupNorm forward + backward launched {counts}: expected "
                                 "K2s and K2a once each")
        want = grads(lambda a, s, t: group_norm_reference(a, s, t, 32, relu=True))
        agree = (got[0] > 0) == (want[0] > 0)
        flips = int((~agree).sum())
        if flips > 1e-6 * agree.numel():
            raise AssertionError(f"GN gradient {dtype}: {flips} ReLU masks differ")
        tol = GN_GRAD_TOL[str(dtype).split(".")[-1]]
        errs = {}
        for name, g, r in zip(("dx", "dscale", "dbias"), got[1:], want[1:]):
            g, r = g.float(), r.float()
            if name == "dx":
                g, r = g[agree], r[agree]
            errs[name] = ((g - r).abs().max() / r.abs().max()).item()
            if not errs[name] <= tol:
                raise AssertionError(f"GN gradient {dtype} {name}: max|err| {errs[name]:.3e} "
                                     f"of its scale > {tol:.1e}")
        log("train", f"GN gradient {list(GN_TRAIN_SHAPE)} G=32 ReLU {dtype}: K2s + K2a + the "
            "registered backward vs autograd through the plain versions: "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
            + f" of scale (tol {tol:g}); {flips} ReLU masks differ (left out of dx)")
        del got, want, agree


def gn_train_yardstick(dev) -> None:
    """Forward + backward of GroupNorm + ReLU at the P3 train shape in bf16:
    K2s + K2a with the registered backward, against ``F.group_norm`` +
    ``F.relu`` with autograd's own backward (which the port never calls),
    on the device and by loop; and their byte bound (the pair's inputs x
    and dy read once, its outputs y and dx written once)."""
    import torch
    import torch.nn.functional as F

    from handnet_tpu_torch.ops.cuda_gn import group_norm

    gen = torch.Generator(device=dev).manual_seed(SEED)
    b, h, w, c = GN_TRAIN_SHAPE
    x = (torch.randn(b, h, w, c, device=dev, generator=gen) * 3 + 2).to(torch.bfloat16)
    dy = torch.randn(b, h, w, c, device=dev, generator=gen).to(torch.bfloat16)
    # float32 parameters, as the trainer holds them; F.group_norm on the card
    # takes them only in x's type
    sc = (torch.rand(c, device=dev, generator=gen) + 0.5).requires_grad_()
    bi = torch.randn(c, device=dev, generator=gen).requires_grad_()
    sc16, bi16 = (t.detach().to(torch.bfloat16).requires_grad_() for t in (sc, bi))
    xk = x.clone().requires_grad_()
    xc = x.permute(0, 3, 1, 2).detach().requires_grad_()   # NCHW view, channels_last bytes
    dyc = dy.permute(0, 3, 1, 2)

    def ours():
        torch.autograd.grad(group_norm(xk, sc, bi, 32, relu=True), (xk, sc, bi), dy)

    def library():
        torch.autograd.grad(F.relu(F.group_norm(xc, 32, sc16, bi16, 1e-5)), (xc, sc16, bi16),
                            dyc)

    t_ours, t_lib = timed(ours), timed(library)
    b_ms = bound(4 * nbytes(x), 0, F32_FLOPS_PER_S)["bound_ms"]
    log("train", f"GroupNorm + ReLU forward + backward at {list(GN_TRAIN_SHAPE)} bf16: K2s + K2a "
        f"+ registered backward {t_ours['ms']:.4f} ms on the device (loop {t_ours['loop_ms']:.4f}); "
        f"F.group_norm + F.relu + autograd {t_lib['ms']:.4f} (loop {t_lib['loop_ms']:.4f}); "
        f"byte bound {b_ms:.4f} ms")


def train_kernels_vs_plain(dev, cfg, tcfg, batch) -> None:
    """One step of two trainers from one seed, K2s/K2a on and off, in bf16
    and in float32 (TF32 off): every loss term and every parameter's
    gradient within ``TRAIN_KERNEL_TOL``."""
    import torch

    from handnet_tpu_torch.train.trainer import FCOSTrainer

    for bf16 in (True, False):
        kind = "bfloat16" if bf16 else "float32"
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = bf16
        runs = []
        for on in (True, False):
            trainer = FCOSTrainer(cfg, dataclasses.replace(tcfg, bf16=bf16),
                                  steps_per_epoch=TRAIN_STEPS_PER_EPOCH,
                                  backbone_norm="batch", device=dev)
            state = trainer.init_state(SEED)
            set_gn_kernels(state.model, on)
            reset_launch_counts()
            state, metrics = trainer.train_step(state, batch)
            counts = launch_counts()
            want = GN_LAYERS_PER_CALL if on else 0
            if (counts["gn_group_stats"], counts["gn_apply"]) != (want, want):
                raise AssertionError(f"train step kernels={on}: launches {counts}")
            runs.append(({k: v.item() for k, v in metrics.items()},
                         {n: p.grad.detach().float().clone()
                          for n, p in state.model.named_parameters()}))
            del trainer, state
            free_device_memory(dev)
        (mk, gk), (mp, gp) = runs
        tol = TRAIN_KERNEL_TOL[kind]
        loss_err = {k: abs(mk[k] - mp[k]) / max(abs(mp[k]), 1e-12) for k in mp}
        grad_err = {n: ((gk[n] - gp[n]).norm() / gp[n].norm().clamp(min=1e-30)).item()
                    for n in gp}
        worst = max(grad_err, key=grad_err.get)
        ranked = sorted(grad_err.values())
        log("train", f"{kind} step, kernels vs plain: losses max rel err "
            f"{max(loss_err.values()):.3e} (tol {tol['loss']:g}); gradients, |g_k - g_p| / |g_p| "
            f"per tensor: median {ranked[len(ranked) // 2]:.3e}, max {grad_err[worst]:.3e} "
            f"({worst}; tol {tol['grad']:g})")
        if max(loss_err.values()) > tol["loss"] or grad_err[worst] > tol["grad"]:
            raise AssertionError(f"{kind} train step: kernels vs plain outside tolerance "
                                 f"({loss_err}, {worst} {grad_err[worst]:.3e})")
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False


def train_step_profile(trainer, state, batch, tag: str = "train") -> None:
    """One step under torch.profiler: the top 10 kernels by device time, the
    share of K2s and K2a (the forward's GroupNorms) and of the GroupNorm
    backward (the ops' registered gradients, read from their profiler
    ranges); logged under ``tag``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from handnet_tpu_torch.ops.cuda_gn import GN_BACKWARD_RANGES

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.train_step(state, batch)
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = sorted(((e.key, getattr(e, "self_device_time_total",
                                      getattr(e, "self_cuda_time_total", 0)) / 1e3, e.count)
                      for e in events
                      if "CUDA" in str(getattr(e, "device_type", ""))
                      and not getattr(e, "is_user_annotation", False)
                      and e.key not in GN_BACKWARD_RANGES), key=lambda r: -r[1])
    total = sum(ms for _, ms, _ in kernels)
    gn_fwd = sum(ms for key, ms, _ in kernels if "gn_stats_kernel" in key
                 or "gn_apply_kernel" in key)
    gn_bwd = sum(getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0)) / 1e3
                 for e in events if e.key in GN_BACKWARD_RANGES
                 and "CPU" in str(getattr(e, "device_type", "")))
    if total <= 0:
        log(tag, "profile of one step: the profiler recorded no device time (not measured)")
        return
    log(tag, f"profile of one step: kernels {total:.3f} ms on the device "
        f"({sum(n for _, _, n in kernels)} launches); K2s + K2a "
        f"(forward) {gn_fwd:.3f} ms = {100 * gn_fwd / total:.2f}%; GroupNorm backward (the "
        f"registered gradients' kernels) {gn_bwd:.3f} ms = {100 * gn_bwd / total:.2f}%"
        + ("" if gn_bwd > 0 else " (not measured: the ranges recorded no kernels)"))
    for key, ms, count in kernels[:10]:
        log(tag, f"  {ms:9.3f} ms {100 * ms / total:6.2f}%  x{count:<4d} {key[:110]}")


def phase_train(dev, cfg) -> dict:
    """``FCOSTrainer`` at the full width of the 100DOH run (800x1088,
    ResNet-34, FPN 256, 4-conv GN towers, ext heads, 3 classes; batch 8,
    SGD lr 1.25e-3 with warmup, bf16, batch-norm backbone) on a seeded
    synthetic batch. Returns K1..K3's launches per train step."""
    import torch

    from handnet_tpu_torch.config import TrainConfig
    from handnet_tpu_torch.models.fcos import anchors_for, match_anchors
    from handnet_tpu_torch.train.trainer import FCOSTrainer

    gn_train_gradient(dev)
    gn_train_yardstick(dev)
    free_device_memory(dev)
    batch = train_batch(dev, cfg, seed=SEED)
    tcfg = TrainConfig(batch_size=TRAIN_BATCH, lr=TRAIN_LR, optimizer="sgd",
                       warmup_epochs=1, bf16=True)

    # the matcher on the card equals its CPU run, exactly, with a pair of
    # GTs whose areas (96 x 96 and 97 x 95) tie in float32 in image 0
    targets = {k: v.clone() for k, v in batch["targets"].items()}
    targets["boxes"][0, 6:] = torch.tensor([[100.0, 100.0, 196.0, 196.0],
                                            [100.0, 100.0, 197.0, 195.0]], device=dev)
    targets["valid"][0, 6:] = True
    anchors, sizes, slices = anchors_for(cfg)
    anchors, sizes = torch.from_numpy(anchors), torch.from_numpy(sizes)
    on_card = match_anchors(anchors.to(dev), sizes.to(dev), slices, targets["boxes"],
                            targets["valid"]).cpu()
    on_cpu = match_anchors(anchors, sizes, slices, targets["boxes"].cpu(),
                           targets["valid"].cpu())
    if not torch.equal(on_card, on_cpu):
        raise AssertionError("match_anchors: card and CPU differ")
    log("train", f"match_anchors at {cfg.image_h}x{cfg.image_w} ({anchors.shape[0]} anchors, "
        f"B={TRAIN_BATCH}, M={TRAIN_MAX_BOXES}, a float32 area tie in image 0): card == CPU; "
        f"{int((on_cpu >= 0).sum())} foreground anchors")

    train_kernels_vs_plain(dev, cfg, tcfg, batch)

    # the learning run: 20 steps on the repeated batch, the loop clock after 3
    trainer = FCOSTrainer(cfg, tcfg, steps_per_epoch=TRAIN_STEPS_PER_EPOCH,
                          backbone_norm="batch", device=dev)
    state = trainer.init_state(SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    metrics = []
    reset_launch_counts()
    for i in range(TRAIN_STEPS):
        if i == TRAIN_WARM_STEPS:
            torch.cuda.synchronize()
            start = time.perf_counter()
        state, m = trainer.train_step(state, batch)
        metrics.append(m)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = launch_counts()
    want = expected_launches(TRAIN_STEPS, GN_LAYERS_PER_CALL)
    want["a2j_decode"] = 0
    if launches != want:
        raise AssertionError(f"train: launches {launches} over {TRAIN_STEPS} steps: expected K2s "
                             f"and K2a {GN_LAYERS_PER_CALL} per step, no K1 or K3")
    peak = torch.cuda.max_memory_allocated()
    losses = {k: torch.stack([m[k] for m in metrics]).cpu() for k in metrics[0]}
    if not all(bool(torch.isfinite(v).all()) for v in losses.values()):
        raise AssertionError(f"train: non-finite losses {losses}")
    total = losses["total_loss"]
    if not total[-1] < TRAIN_LEARN_SHARE * total[0]:
        raise AssertionError(f"train: total loss {total[0]:.4f} -> {total[-1]:.4f}, not below "
                             f"{TRAIN_LEARN_SHARE} x the first")
    if any(p.dtype != torch.float32 for p in state.model.parameters()):
        raise AssertionError("train: master parameters are not float32")
    ms = seconds / (TRAIN_STEPS - TRAIN_WARM_STEPS) * 1e3
    log("train", f"{TRAIN_STEPS} bf16 steps at {cfg.image_h}x{cfg.image_w}, batch {TRAIN_BATCH}: "
        f"{ms:.3f} ms per step (loop clock over steps {TRAIN_WARM_STEPS + 1}-{TRAIN_STEPS}), "
        f"{TRAIN_BATCH / ms * 1e3:.2f} images/s; peak memory "
        f"{peak / 2**30:.3f} GiB (torch.cuda.max_memory_allocated); launches per step "
        f"{per_call(launches, TRAIN_STEPS)}; master parameters float32")
    log("train", "total loss by step: " + ", ".join(f"{v:.4f}" for v in total.tolist())
        + f" ({total[-1] / total[0]:.4f} of the first; tol < {TRAIN_LEARN_SHARE})")
    log("train", "last step's terms: " + ", ".join(f"{k} {v[-1]:.4f}" for k, v in losses.items()))
    train_step_profile(trainer, state, batch)
    TRAINED["fcos"] = (state.model.cpu(), cfg)   # for [demo_apps]' statepack
    del trainer, state, metrics
    free_device_memory(dev)

    # a frozen backbone: eval-mode statistics, a trainable affine
    trainer = FCOSTrainer(cfg, tcfg, steps_per_epoch=TRAIN_STEPS_PER_EPOCH,
                          backbone_norm="frozen", device=dev)
    state = trainer.init_state(SEED)
    body = state.model.backbone["body"]
    before = {k: v.clone() for k, v in body.state_dict().items()}
    state, m = trainer.train_step(state, batch)
    after = body.state_dict()
    stats_same = all(torch.equal(before[k], after[k]) for k in before
                     if k.endswith(("running_mean", "running_var")))
    affine_moved = sum(not torch.equal(before[k], after[k]) for k in before
                       if k.endswith(("bn1.weight", "bn1.bias")))
    if not (all(bool(torch.isfinite(v)) for v in m.values()) and stats_same and affine_moved):
        raise AssertionError(f"frozen step: finite {[float(v) for v in m.values()]}, statistics "
                             f"unchanged {stats_same}, bn1 affines moved {affine_moved}")
    log("train", f"frozen backbone, one step: total loss {m['total_loss'].item():.4f}, finite; "
        f"running statistics unchanged; {affine_moved} bn1 weight/bias tensors moved")
    del trainer, state, batch
    free_device_memory(dev)
    return per_call(launches, TRAIN_STEPS)


# --- training: A2JTrainer (apps/train_a2j.py's recipe) and the Pose2Mesh app ---

def a2j_train_batch(batch: int, seed: int, crop: int = 176, joints: int = 21) -> dict:
    """``batch`` seeded A2J samples on the host, in the ranges of
    ``build_a2j_sample`` (data/a2j_data.py): a depth crop in metres, a
    background at 0.9-1.2 m with 5 mm of noise and, nearer, a hand of
    ``joints`` discs (radius 7 px) at 0.4-0.8 m around joints scattered
    about a centre of the crop; ``jt_uvd`` is the joints' u, v in crop
    pixels and d in metres."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    centre = rng.uniform(0.35, 0.65, size=(batch, 1, 2)) * crop
    uv = np.clip(centre + rng.normal(0.0, 0.15 * crop, size=(batch, joints, 2)), 2, crop - 3)
    d = rng.uniform(0.4, 0.8, size=(batch, 1, 1)) + rng.normal(0.0, 0.02, size=(batch, joints, 1))
    depth = (rng.uniform(0.9, 1.2, size=(batch, 1, 1))
             + rng.normal(0.0, 0.005, size=(batch, crop, crop)))
    yy, xx = np.mgrid[0:crop, 0:crop]
    for j in range(joints):
        u, v, dj = (a[:, j, k, None, None] for a, k in ((uv, 0), (uv, 1), (d, 0)))
        disc = (xx - u) ** 2 + (yy - v) ** 2 <= 49
        depth = np.where(disc & (dj < depth), dj, depth)
    return {"image": torch.from_numpy(depth[..., None].astype(np.float32)),
            "jt_uvd": torch.from_numpy(np.concatenate([uv, d], axis=-1).astype(np.float32))}


def a2j_card_vs_cpu(dev, cfg, tcfg) -> None:
    """One float32 step (TF32 off) of two trainers from one seed, on the
    card and on the CPU, on ``A2J_CHECK_BATCH`` samples: every loss term
    and every parameter's gradient within ``A2J_CPU_TOL``."""
    import torch

    from handnet_tpu_torch.train.trainer import A2JTrainer

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    batch = a2j_train_batch(A2J_CHECK_BATCH, SEED + 1, cfg.crop_h, cfg.num_joints)
    runs = []
    for device in (dev, torch.device("cpu")):
        trainer = A2JTrainer(cfg, dataclasses.replace(tcfg, bf16=False), device=device)
        state, metrics = trainer.train_step(trainer.init_state(SEED),
                                            {k: v.to(device) for k, v in batch.items()})
        runs.append(({k: v.item() for k, v in metrics.items()},
                     {n: p.grad.detach().double().cpu() for n, p in
                      state.model.named_parameters()}))
        del trainer, state
    free_device_memory(dev)
    torch.backends.cudnn.allow_tf32 = True
    (m_card, g_card), (m_cpu, g_cpu) = runs
    loss_err = {k: abs(m_card[k] - m_cpu[k]) / abs(m_cpu[k]) for k in m_cpu}
    zero, grad_err = {}, {}
    for name in g_cpu:
        if re.fullmatch(r"\w+Model\.conv[1-4]\.bias", name):
            weight = name[:-len("bias")] + "weight"
            zero[name] = max((g[name].norm() / g[weight].norm()).item() for g in (g_card, g_cpu))
        else:
            grad_err[name] = ((g_card[name] - g_cpu[name]).norm()
                              / g_cpu[name].norm().clamp(min=1e-30)).item()
    ranked = sorted(grad_err.values())
    worst = max(grad_err, key=grad_err.get)
    median = ranked[len(ranked) // 2]
    log("train_a2j", f"float32 step (TF32 off), batch {A2J_CHECK_BATCH}, card vs CPU: losses "
        + ", ".join(f"{k} {m_card[k]:.6f} / {m_cpu[k]:.6f} ({loss_err[k]:.2e})" for k in m_cpu)
        + f" (tol {A2J_CPU_TOL['loss']:g}); gradients |g_card - g_cpu| / |g_cpu| over "
        f"{len(grad_err)} tensors: median {median:.3e} (tol {A2J_CPU_TOL['grad_median']:g}), "
        f"max {grad_err[worst]:.3e} ({worst}; tol {A2J_CPU_TOL['grad_max']:g}); the "
        f"{len(zero)} head-conv biases before a BatchNorm: gradient at most "
        f"{max(zero.values()):.2e} of their weight's (tol {A2J_ZERO_GRAD:g})")
    if (max(loss_err.values()) > A2J_CPU_TOL["loss"] or median > A2J_CPU_TOL["grad_median"]
            or grad_err[worst] > A2J_CPU_TOL["grad_max"] or max(zero.values()) > A2J_ZERO_GRAD):
        raise AssertionError("train_a2j: the card's float32 step differs from the CPU's "
                             "beyond the tolerances above")


def batch_norm_share(trainer, state, batch, kernel_ms: float) -> None:
    """The BatchNorm passes alone: every ``BatchNorm2d`` of a train step,
    forward and backward, on inputs of the shape, dtype and layout it saw
    in the step (recorded by hooks in one more step), in fresh layers of
    its width, timed on the device; and their share of the step's
    ``kernel_ms``."""
    import torch

    from handnet_tpu_torch.nn.resnet import BatchNorm2d

    seen = []
    hooks = [m.register_forward_hook(lambda mod, args, out: seen.append(args[0].detach()))
             for m in state.model.modules() if isinstance(m, BatchNorm2d)]
    trainer.train_step(state, batch)
    for hook in hooks:
        hook.remove()
    gen = torch.Generator(device=batch["image"].device).manual_seed(SEED)
    cases = []
    for x in seen:
        xs = torch.randn(x.shape, generator=gen, device=x.device).to(x.dtype).contiguous(
            memory_format=torch.channels_last).requires_grad_()
        cases.append((BatchNorm2d(x.shape[1]).to(x.device).train(), xs, torch.randn_like(xs)))
    del seen

    def passes():
        for bn, x, dy in cases:
            torch.autograd.grad(bn(x), (x, bn.weight, bn.bias), dy)

    ms = device_ms(passes, iters=3, warmup=1)
    elements = sum(x.numel() for _, x, _ in cases)
    log("train_a2j", f"the {len(cases)} BatchNorm2d layers alone (forward + backward, "
        f"{elements / 1e6:.1f} M activations in {cases[0][1].dtype}, channels_last): "
        f"{ms:.3f} ms on the device = {100 * ms / kernel_ms:.2f}% of the step's "
        f"{kernel_ms:.3f} ms of kernels")
    del cases


def a2j_step_profile(trainer, state, batch) -> float:
    """One train step under torch.profiler: the top 10 kernels by device
    time; returns the step's kernel ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trainer.train_step(state, batch)
        torch.cuda.synchronize()
    kernels = sorted(device_rows(prof), key=lambda r: -r[1])
    total = sum(ms for _, ms, _ in kernels)
    if total <= 0:
        log("train_a2j", "profile of one step: the profiler recorded no device time "
            "(not measured)")
        return float("nan")
    log("train_a2j", f"profile of one step: kernels {total:.3f} ms on the device, "
        f"{sum(n for _, _, n in kernels)} launches")
    for key, ms, count in kernels[:10]:
        log("train_a2j", f"  {ms:9.3f} ms {100 * ms / total:6.2f}%  x{count:<4d} {key[:110]}")
    return total


def phase_train_a2j(dev) -> dict:
    """``A2JTrainer`` at apps/train_a2j.py's recipe (176^2 depth crops,
    dilated ResNet-50, three 256-wide 4-conv towers, 16 anchors, 21 joints;
    batch 64, AdamW 3.5e-4, bf16, batch-norm A2J) on a seeded synthetic
    batch. Returns K1..K3's launches per train step and per eval step."""
    import torch

    from handnet_tpu_torch.config import A2JConfig, TrainConfig
    from handnet_tpu_torch.train.trainer import A2JTrainer

    cfg, tcfg = A2JConfig(), TrainConfig(batch_size=A2J_TRAIN_BATCH)
    a2j_card_vs_cpu(dev, cfg, tcfg)

    # the learning run: 20 steps on the repeated batch, the loop clock after 3
    batch = {k: v.to(dev) for k, v in
             a2j_train_batch(A2J_TRAIN_BATCH, SEED, cfg.crop_h, cfg.num_joints).items()}
    trainer = A2JTrainer(cfg, tcfg, device=dev)
    state = trainer.init_state(SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    metrics = []
    reset_launch_counts()
    for i in range(TRAIN_STEPS):
        if i == TRAIN_WARM_STEPS:
            torch.cuda.synchronize()
            start = time.perf_counter()
        state, m = trainer.train_step(state, batch)
        metrics.append(m)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    train_launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if any(train_launches.values()):
        raise AssertionError(f"train_a2j: launches {train_launches} over {TRAIN_STEPS} steps: "
                             "a train step launches no kernel of the port")
    losses = {k: torch.stack([m[k] for m in metrics]).cpu() for k in metrics[0]}
    if not all(bool(torch.isfinite(v).all()) for v in losses.values()):
        raise AssertionError(f"train_a2j: non-finite losses {losses}")
    total = losses["total_loss"]
    if not total[-1] < TRAIN_LEARN_SHARE * total[0]:
        raise AssertionError(f"train_a2j: total loss {total[0]:.4f} -> {total[-1]:.4f}, not "
                             f"below {TRAIN_LEARN_SHARE} x the first")
    if any(p.dtype != torch.float32 for p in state.model.parameters()):
        raise AssertionError("train_a2j: master parameters are not float32")
    ms = seconds / (TRAIN_STEPS - TRAIN_WARM_STEPS) * 1e3
    log("train_a2j", f"{TRAIN_STEPS} bf16 steps at {cfg.crop_h}x{cfg.crop_w}, batch "
        f"{A2J_TRAIN_BATCH}: {ms:.3f} ms per step (loop clock over steps "
        f"{TRAIN_WARM_STEPS + 1}-{TRAIN_STEPS}), {A2J_TRAIN_BATCH / ms * 1e3:.1f} samples/s; "
        f"peak memory {peak / 2**30:.3f} GiB (torch.cuda.max_memory_allocated); launches per "
        f"step {per_call(train_launches, TRAIN_STEPS)}; master parameters float32")
    log("train_a2j", "total loss by step: " + ", ".join(f"{v:.4f}" for v in total.tolist())
        + f" ({total[-1] / total[0]:.4f} of the first; tol < {TRAIN_LEARN_SHARE})")
    log("train_a2j", "last step's terms: "
        + ", ".join(f"{k} {v[-1]:.4f}" for k, v in losses.items()))
    kernel_ms = a2j_step_profile(trainer, state, batch)
    if kernel_ms == kernel_ms:
        batch_norm_share(trainer, state, batch, kernel_ms)

    # the eval step: K1 twice (the same bits), then the plain decode
    reset_launch_counts()
    pred, rmse = trainer.eval_step(state, batch)
    pred2, rmse2 = trainer.eval_step(state, batch)
    eval_launches = launch_counts()
    state.model.use_kernels = False
    plain, rmse_plain = trainer.eval_step(state, batch)
    state.model.use_kernels = True
    if eval_launches != {**{k: 0 for k in eval_launches}, "a2j_decode": 2}:
        raise AssertionError(f"eval_a2j: launches {eval_launches} over 2 eval steps: expected "
                             "K1 once per step and nothing else")
    if not (torch.equal(pred, pred2) and torch.equal(rmse, rmse2)):
        raise AssertionError("eval_a2j: two eval steps through K1 differ")
    scale = plain.abs().max().item()
    err = check("eval_a2j K1 vs plain decode", pred, plain, A2J_EVAL_TOL * scale)
    rmse_err = abs(rmse.item() - rmse_plain.item()) / rmse_plain.item()
    if not rmse_err <= A2J_RMSE_TOL:
        raise AssertionError(f"eval_a2j: rmse {rmse.item()} vs plain {rmse_plain.item()}")
    log("train_a2j", f"eval step (running statistics, bf16 forward, batch {A2J_TRAIN_BATCH}): "
        f"pred {tuple(pred.shape)} through K1 == the plain decode within {err:.3e} (tol "
        f"{A2J_EVAL_TOL:g} of {scale:.1f}), two runs bit-equal; rmse {rmse.item():.4f} vs "
        f"{rmse_plain.item():.4f} ({rmse_err:.2e}, tol {A2J_RMSE_TOL:g}); launches per eval "
        f"step {per_call(eval_launches, 2)}")
    TRAINED["a2j"] = (state.model.cpu(), cfg)    # for [demo_apps]' statepack
    del trainer, state, batch, metrics
    free_device_memory(dev)
    return {"train_a2j": per_call(train_launches, TRAIN_STEPS),
            "eval_a2j": per_call(eval_launches, 2)}


def phase_train_mesh(dev) -> dict:
    """The Pose2Mesh app (``apps/train_pose2mesh.py``) at its defaults,
    float32 with TF32 off: one step card against CPU on one batch and init,
    then ``main(["--synthetic", "--steps", "20", "--device", "cuda"])`` into
    a temporary directory; the loss must fall on the first batch. Returns
    K1..K3's launches per step (none)."""
    import tempfile

    import numpy as np
    import torch

    from handnet_tpu_torch.apps import train_pose2mesh as app
    from handnet_tpu_torch.convert.from_flax import _leaves, pose2mesh_variables_from_state_dict
    from handnet_tpu_torch.models.mano import ManoLayer
    from handnet_tpu_torch.train.checkpoints import load_params_npz
    from handnet_tpu_torch.train.pose2mesh_loss import pose2mesh_losses

    torch.backends.cuda.matmul.allow_tf32 = False
    log("train_mesh", f"float32; torch.backends.cuda.matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32}")

    # one step on one batch from one init, card against CPU
    rng = np.random.default_rng(0)
    assets = app.load_assets(None, True, rng)
    faces = app.training_faces(assets)
    pyramid = app.build_pyramid(faces)
    batch = app.make_batch(rng, ManoLayer(assets, flat_hand_mean=True, device="cpu"),
                           MESH_TRAIN_BATCH)
    order = torch.from_numpy(pyramid.perm_reverse[:faces.max() + 1])
    runs = []
    for device in (dev, torch.device("cpu")):
        state = app.init_state(pyramid, MESH_TRAIN_LR, device)
        losses = app.train_step(state, order.to(device), torch.from_numpy(faces).to(device),
                                *(t.to(device) for t in batch))
        runs.append({k: v.item() for k, v in losses.items()})
        del state
    errs = {k: abs(runs[0][k] - runs[1][k]) / abs(runs[1][k]) for k in runs[1]}
    log("train_mesh", f"one step at batch {MESH_TRAIN_BATCH}, card vs CPU: "
        + ", ".join(f"{k} {runs[0][k]:.6f} / {runs[1][k]:.6f} ({errs[k]:.2e})" for k in errs)
        + f" (tol {MESH_CPU_TOL:g})")
    if max(errs.values()) > MESH_CPU_TOL:
        raise AssertionError(f"train_mesh: card vs CPU losses {errs}")
    free_device_memory(dev)

    # the entry point at its defaults
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    with tempfile.TemporaryDirectory() as out:
        res = app.main(["--synthetic", "--steps", str(MESH_TRAIN_STEPS), "--batch",
                        str(MESH_TRAIN_BATCH), "--device", "cuda", "--output", out])
        torch.cuda.synchronize()
        launches = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        saved = {"/".join(p) for p, _ in _leaves(load_params_npz(res["params_npz"]))}
    model = res["state"].model
    want = {"/".join(p) for p, _ in
            _leaves(pose2mesh_variables_from_state_dict(model.state_dict())["params"])}
    if saved != want or "pose_lifter/stage1/bn2/scale" not in saved:
        raise AssertionError(f"train_mesh: params.npz keys {sorted(saved ^ want)} differ")
    if any(launches.values()):
        raise AssertionError(f"train_mesh: launches {launches}: the path runs no kernel of ours")
    # each step draws a new batch, whose loss moves by about 1% from batch to
    # batch, more than 20 steps at lr 1e-4 learn; so the fall is read on the
    # first batch, made again as main() made it: the trained model's losses
    # against the first step's (the initial model's) on the same batch
    rng = np.random.default_rng(0)
    first = app.make_batch(rng, ManoLayer(app.load_assets(None, True, rng), flat_hand_mean=True,
                                          device=dev), MESH_TRAIN_BATCH)
    with torch.no_grad():
        mesh, pose3d = model(first[0])
        trained = {k: v.item() for k, v in pose2mesh_losses(
            mesh[:, order.to(dev)], first[1], pose3d, first[2],
            faces=torch.from_numpy(faces).to(dev)).items()}
    totals = [step["total_loss"] for step in res["losses"]]
    if not (np.isfinite([list(step.values()) for step in res["losses"]]).all()
            and trained["total_loss"] < totals[0]):
        raise AssertionError(f"train_mesh: total loss {totals}; on the first batch after "
                             f"training {trained}")
    ends = res["step_end_s"]
    ms = (ends[-1] - ends[TRAIN_WARM_STEPS - 1]) / (MESH_TRAIN_STEPS - TRAIN_WARM_STEPS) * 1e3
    log("train_mesh", f"main() at its defaults (PoseNet 4096 x 2, Chebyshev order 3, the "
        f"{'/'.join(map(str, pyramid.mesh_sizes))}-node pyramid with the HORI joint graph), "
        f"{MESH_TRAIN_STEPS} steps of batch {MESH_TRAIN_BATCH}: {ms:.3f} ms per step (loop "
        f"clock over steps {TRAIN_WARM_STEPS + 1}-{MESH_TRAIN_STEPS}, MANO and the batch "
        f"included), {MESH_TRAIN_BATCH / ms * 1e3:.1f} samples/s; peak memory "
        f"{peak / 2**30:.3f} GiB; params.npz holds the {len(saved)} flax keys; launches "
        f"{launches}")
    log("train_mesh", "total loss by step (a new batch each step): "
        + ", ".join(f"{v:.2f}" for v in totals))
    log("train_mesh", "on the first batch, before -> after the 20 steps: " + ", ".join(
        f"{k} {res['losses'][0][k]:.4f} -> {trained[k]:.4f}" for k in trained)
        + f" ({trained['total_loss'] / totals[0]:.4f} of the first; gate < 1)")
    del res, model
    free_device_memory(dev)
    return per_call(launches, MESH_TRAIN_STEPS)


def host_data_costs(root: str, crop: int) -> None:
    """One host core's cost of the A2J data path on the tree at ``root``:
    decoding a 480x640 depth frame re-encoded with each PNG filter, and
    building one augmented and one plain sample (``A2JDataSource``: the
    PNG, the label npz, the RLE box, the crop, the rotation). Where ``cv2``
    is installed, the port's resamplers against it (printed, not a gate:
    the port does not use it)."""
    import glob
    import threading

    import numpy as np

    from handnet_tpu_torch.data import a2j_data, image_io
    from handnet_tpu_torch.data.dexycb import DexYCBDataset, refine_indices

    others = [t.name for t in threading.enumerate() if t is not threading.current_thread()]
    log("a2j_apps", f"other Python threads alive: {len(others)} {sorted(others)[:8]}")
    frame = image_io.read_png(sorted(glob.glob(f"{root}/**/*.png", recursive=True))[0])
    costs = []
    for kind in range(5):
        data = image_io.encode_png(frame, kind)
        image_io.decode_png(data)   # the unfilter library's build, at first use
        start = time.perf_counter()
        for _ in range(20):
            got = image_io.decode_png(data)
        costs.append((time.perf_counter() - start) / 20 * 1e3)
        if not np.array_equal(got, frame):
            raise AssertionError(f"a2j_apps: PNG filter {kind} does not round-trip")
    log("a2j_apps", "host decode of one 480x640 16-bit depth PNG (ms, one core; numpy for "
        "None/Sub/Up, the C++ unfilter for Average/Paeth): " + ", ".join(
            f"{image_io.FILTER_NAMES[k]} {ms:.3f}" for k, ms in enumerate(costs))
        + " (the tree's files are Sub)")
    ds = DexYCBDataset("s0", "train", root)
    idx = refine_indices(ds)[:32]
    cfg = a2j_data.A2JSampleConfig(crop_w=crop, crop_h=crop)
    for augment in (True, False):
        source = a2j_data.A2JDataSource(ds, idx, augment=augment, cfg=cfg)
        start = time.perf_counter()
        for i in range(len(idx)):
            source[i]
        ms = (time.perf_counter() - start) / len(idx) * 1e3
        log("a2j_apps", f"one {crop}x{crop} sample on one core, augment={augment}: {ms:.3f} ms "
            f"(PNG, npz, RLE box, crop{', rotation' if augment else ''}), "
            f"{ms * A2J_TRAIN_BATCH:.1f} ms for a batch of {A2J_TRAIN_BATCH}")
    try:
        import cv2
    except ImportError:
        return
    rng = np.random.default_rng(SEED)
    img = np.full((crop, crop), 2.0, np.float32)
    img[crop // 4:crop // 2, crop // 3:2 * crop // 3] = 0.6
    img += rng.uniform(0, 0.02, img.shape).astype(np.float32)
    worst = 0.0
    for angle in range(-180, 180, 10):
        m = a2j_data._rotation_matrix(crop / 2, crop / 2, angle)
        worst = max(worst, float(np.abs(a2j_data.warp_affine_bilinear(img, m, crop, crop)
                                        - cv2.warpAffine(img, m, (crop, crop))).max()))
    same = np.array_equal(a2j_data.resize_nearest(frame, crop, crop),
                          cv2.resize(frame, (crop, crop), interpolation=cv2.INTER_NEAREST))
    log("a2j_apps", f"cv2 {cv2.__version__} on this host (not used by the port): "
        f"warp_affine_bilinear (OpenCV 4's 1/32-pixel grid) vs cv2.warpAffine over 36 "
        f"angles max |diff| {worst:.3e} m; resize_nearest == cv2 INTER_NEAREST: {same}")


def loader_contention(dev, root: str, crop: int) -> None:
    """``A2JTrainer.train_step`` at the recipe on one device batch, 5 steps
    alone and 5 while ``A2J_APPS_WORKERS`` loader threads build augmented
    samples of the tree (host clock; each step ends in reading its loss):
    what the loader's threads cost the thread that launches the step."""
    import threading

    import torch

    from handnet_tpu_torch.config import A2JConfig, TrainConfig
    from handnet_tpu_torch.data.a2j_data import A2JDataSource, A2JSampleConfig
    from handnet_tpu_torch.data.dexycb import DexYCBDataset, refine_indices
    from handnet_tpu_torch.data.loader import PrefetchLoader, collate_stack
    from handnet_tpu_torch.train.trainer import A2JTrainer

    ds = DexYCBDataset("s0", "train", root)
    source = A2JDataSource(ds, refine_indices(ds), augment=True,
                           cfg=A2JSampleConfig(crop_w=crop, crop_h=crop))
    host = collate_stack([source[i] for i in range(A2J_TRAIN_BATCH)])
    batch = {"image": torch.from_numpy(host["depth"]).to(dev),
             "jt_uvd": torch.from_numpy(host["jt_uvd"]).to(dev)}
    trainer = A2JTrainer(A2JConfig(crop_h=crop, crop_w=crop),
                         TrainConfig(batch_size=A2J_TRAIN_BATCH), device=dev)
    state = trainer.init_state(SEED)

    def steps(n: int) -> float:
        start = time.perf_counter()
        for _ in range(n):
            trainer.train_step(state, batch)[1]["total_loss"].item()
        return (time.perf_counter() - start) / n * 1e3

    steps(TRAIN_WARM_STEPS)
    alone = steps(5)
    stop = threading.Event()
    built = []

    def drain():
        loader = PrefetchLoader(source, A2J_TRAIN_BATCH, shuffle=True,
                                num_workers=A2J_APPS_WORKERS)
        while not stop.is_set():
            for _ in loader:
                built.append(1)
                if stop.is_set():
                    return

    feeder = threading.Thread(target=drain, daemon=True)
    feeder.start()
    time.sleep(0.5)
    beside = steps(5)
    stop.set()
    feeder.join()
    log("a2j_apps", f"a train step at batch {A2J_TRAIN_BATCH} on one device batch: "
        f"{alone:.3f} ms alone, {beside:.3f} ms while {A2J_APPS_WORKERS} loader threads build "
        f"samples ({len(built)} batches built meanwhile; host clock, each step reads its loss)")
    del trainer, state, batch


def phase_a2j_apps(dev) -> dict:
    """The A2J apps on the card, through their entry points: the port's
    synthetic tree, ``train_a2j.main`` at the recipe (crop 176, batch 64,
    bf16, AdamW 3.5e-4, 8 loader threads, an eval sweep after each epoch
    through K1), ``eval_hpe.main`` on its last result file, and
    ``a2j_infer.main`` over 256 of the tree's PNGs with its params.npz,
    then the same frames through the plain decode. Returns K1..K3's
    launches per eval batch and per a2j_infer batch."""
    import argparse
    import os
    import tempfile

    import numpy as np
    import torch

    from handnet_tpu_torch.apps import a2j_infer, eval_hpe, train_a2j
    from handnet_tpu_torch.data.synthetic import make_synthetic_dexycb

    crop, batch = A2J_APPS_CROP, A2J_TRAIN_BATCH
    with tempfile.TemporaryDirectory() as work:
        root, out = os.path.join(work, "tree"), os.path.join(work, "a2j")
        start = time.perf_counter()
        make_synthetic_dexycb(root, n_sequences=A2J_APPS_SEQUENCES, n_frames=4)
        log("a2j_apps", f"synthetic tree ({A2J_APPS_SEQUENCES} sequences x 4 frames, 480x640) "
            f"in {time.perf_counter() - start:.2f} s")
        host_data_costs(root, crop)

        reset_launch_counts()
        res = train_a2j.main(["--data-dir", root, "--synthetic", str(A2J_APPS_SEQUENCES),
                              "--crop", str(crop), "--batch", str(batch), "--epochs",
                              str(A2J_APPS_EPOCHS), "--eval-every", "1", "--workers",
                              str(A2J_APPS_WORKERS), "--output", out, "--device", "cuda"])
        torch.cuda.synchronize()
        launches = launch_counts()
        for e in res["epochs"]:
            log("a2j_apps", f"epoch {e['epoch']}: {e['steps']} steps of batch {batch}, "
                f"{e['ms_per_step']:.3f} ms per step, {e['samples_per_s']:.1f} samples/s, "
                f"{100 * e['loader_wait_share']:.2f}% of the epoch waiting on the loader "
                f"({e['seconds']:.3f} s; loop clock), mean loss "
                f"{e['losses']['total_loss']:.4f}")
        sweeps = res["evals"]
        n_test = sweeps[-1]["samples"]
        eval_batches = sum(s["batches"] for s in sweeps)
        want = {**{k: 0 for k in launches}, "a2j_decode": len(sweeps) * math.ceil(n_test / batch)}
        log("a2j_apps", f"{len(sweeps)} eval sweeps of {n_test} samples, "
            f"{eval_batches} batches: launches {launches} (K1 "
            f"{launches['a2j_decode'] / len(sweeps):g} per sweep = ceil({n_test} / {batch}))")
        if launches != want or any(s["batches"] != math.ceil(n_test / batch) for s in sweeps):
            raise AssertionError(f"a2j_apps: launches {launches}, expected {want}")
        res_file = sweeps[-1]["res_file"]
        with open(res_file) as f:
            fields = {len(line.split(",")) for line in f.read().split()}
        results = sweeps[-1]["results"]
        finite = all(np.isfinite(list(v.values())).all() for s in sweeps
                     for v in s["results"].values())
        first, last = (res["epochs"][i]["losses"]["total_loss"] for i in (0, -1))
        if (fields != {64} or not finite or not os.path.exists(res["params_npz"])
                or not os.path.exists(res["batch_stats_npz"]) or not last < first):
            raise AssertionError(f"a2j_apps: result fields {fields}, finite {finite}, mean "
                                 f"loss {first} -> {last}")
        log("a2j_apps", "HPE after the last epoch: " + ", ".join(
            f"{k} MPJPE {v['mpjpe']:.2f} mm AUC {v['auc']:.4f}" for k, v in results.items())
            + f"; mean loss {first:.4f} -> {last:.4f}; every result line has 64 fields; "
            "params.npz and batch_stats.npz written")
        del res
        free_device_memory(dev)
        loader_contention(dev, root, crop)
        free_device_memory(dev)

        again = eval_hpe.main(["--res-file", res_file, "--data-dir", root, "--split",
                               "s0_train"])
        if again != results:
            raise AssertionError(f"a2j_apps: eval_hpe {again} != the CLI's {results}")
        log("a2j_apps", "eval_hpe on the last result file and the tree == the CLI's numbers")

        pngs = sorted(os.path.join(d, f) for d, _, files in os.walk(root)
                      for f in files if f.endswith(".png"))[:A2J_INFER_FRAMES]
        folder = os.path.join(work, "pngs")
        os.makedirs(folder)
        for i, path in enumerate(pngs):
            os.symlink(path, os.path.join(folder, f"{i:04d}.png"))
        args = ["--input", folder, "--output", os.path.join(work, "uvd"), "--checkpoint", out,
                "--batch", str(batch), "--crop", str(crop), "--device", "cuda"]
        runs = []
        for _ in range(2):
            reset_launch_counts()
            runs.append(a2j_infer.main(args))
            torch.cuda.synchronize()
            infer_launches = launch_counts()
            want = {**{k: 0 for k in infer_launches},
                    "a2j_decode": math.ceil(len(pngs) / batch)}
            if infer_launches != want:
                raise AssertionError(f"a2j_infer: launches {infer_launches}, expected {want}")
        uvd = runs[-1]["uvd"]
        if uvd.shape != (len(pngs), 21, 3) or not np.isfinite(uvd).all():
            raise AssertionError(f"a2j_infer: UVD {uvd.shape}, finite {np.isfinite(uvd).all()}")
        system = a2j_infer.build_system(argparse.Namespace(
            crop=crop, checkpoint=out, torch_checkpoint=None), dev)
        system.use_kernels = False
        plain = a2j_infer.predict_frames(system, a2j_infer.read_frames(pngs, crop), batch)
        err = float(np.abs(uvd - plain).max())
        if not err <= A2J_INFER_TOL:
            raise AssertionError(f"a2j_infer: K1 vs plain decode {err} px")
        for i, r in enumerate(runs):
            total = r["read_s"] + r["predict_s"]
            log("a2j_infer", f"run {i + 1}: {len(pngs)} frames at batch {batch}: "
                f"{len(pngs) / total:.1f} frames/s with the host decode "
                f"({r['read_s'] / len(pngs) * 1e3:.3f} ms per frame to read and resize, "
                f"{r['predict_s'] / r['batches'] * 1e3:.3f} ms per batch of {batch} on the "
                "card, float32)")
        log("a2j_infer", f"all_joints_uvd {uvd.shape} finite; K1 launches per run "
            f"{infer_launches['a2j_decode']}; == the plain decode within {err:.3e} px "
            f"(tol {A2J_INFER_TOL:g})")
        del system
    free_device_memory(dev)
    return {"a2j_apps_eval": per_call(launches, eval_batches),
            "a2j_infer": per_call(infer_launches, runs[-1]["batches"])}


# --- the FCOS apps: the JPEG codec, train_fcos, eval_fcos, train_a2j --rgbd ---

def write_voc_tree(root: str, tree: str, seed: int) -> int:
    """A 100DOH-layout VOC tree (as tests/test_voc100doh.py writes one) made
    of the synthetic DexYCB tree at ``tree``: its first
    ``FCOS_APPS_VOC_PER_SIZE`` colour frames at each of
    ``FCOS_APPS_VOC_SIZES`` (resized with ``resize_linear_u8`` where the size
    differs; written by the port's ``imwrite_jpeg``), each with its hand
    (the seg's 255 pixels; a contact state, side, offset and its object's
    box) and its YCB object (the seg's 1 pixels) annotated, listed in
    ``trainval`` size by size. Returns the image count."""
    import glob
    import os
    import xml.etree.ElementTree as ET

    import numpy as np

    from handnet_tpu_torch.data import image_io

    devkit = os.path.join(root, "VOC2007")
    for sub in ("Annotations", "ImageSets/Main", "JPEGImages"):
        os.makedirs(os.path.join(devkit, sub), exist_ok=True)
    rng = np.random.default_rng(seed)
    frames = sorted(glob.glob(f"{tree}/**/color_*.jpg", recursive=True))[:FCOS_APPS_VOC_PER_SIZE]
    names = []
    for h, w in FCOS_APPS_VOC_SIZES:
        for path in frames:
            name = f"img{len(names):04d}"
            img = image_io.imread_color(path)
            seg = np.load(path.replace("color_", "labels_").replace(".jpg", ".npz"))["seg"]
            sx, sy = w / img.shape[1], h / img.shape[0]
            if img.shape[:2] != (h, w):
                img = image_io.resize_linear_u8(img, w, h)
            image_io.imwrite_jpeg(os.path.join(devkit, "JPEGImages", f"{name}.jpg"), img)
            boxes = {}
            for kind, value in (("hand", 255), ("targetobject", 1)):
                ys, xs = np.nonzero(seg == value)
                boxes[kind] = (int(xs.min() * sx), int(ys.min() * sy),
                               int(xs.max() * sx), int(ys.max() * sy))
            ox0, oy0, ox1, oy1 = boxes["targetobject"]
            ann = ET.Element("annotation")
            for kind, extra in (
                    ("hand", {"contactstate": 3, "handside": int(rng.integers(0, 2)),
                              "magnitude": 150, "unitdx": 0.8, "unitdy": 0.6, "objxmin": ox0,
                              "objymin": oy0, "objxmax": ox1, "objymax": oy1}),
                    ("targetobject", {})):
                obj = ET.SubElement(ann, "object")
                ET.SubElement(obj, "name").text = kind
                bb = ET.SubElement(obj, "bndbox")
                for k, v in zip(("xmin", "ymin", "xmax", "ymax"), boxes[kind]):
                    ET.SubElement(bb, k).text = str(v + 1)    # VOC boxes are 1-based
                ET.SubElement(obj, "difficult").text = "0"
                for k in ("contactstate", "handside", "magnitude", "unitdx", "unitdy",
                          "objxmin", "objymin", "objxmax", "objymax"):
                    ET.SubElement(obj, k).text = str(extra.get(k, "None"))
            ET.ElementTree(ann).write(os.path.join(devkit, "Annotations", f"{name}.xml"))
            names.append(name)
    with open(os.path.join(devkit, "ImageSets", "Main", "trainval.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    return len(names)


def codec_checks(jpegs: list) -> None:
    """The port's JPEG decode against ``cv2.imread`` on every file of both
    trees, where cv2 imports (a gate: no pixel may differ); its encode
    against ``cv2.imencode`` (bytes compared, printed) and the decode and
    encode ms per 480x640 frame on one core; ``resize_linear_u8`` against
    ``cv2.resize`` in both of its roundings (printed: the host's OpenCV
    may round either way)."""
    import numpy as np

    from handnet_tpu_torch.data import image_io, jpeg

    frames = {}
    start = time.perf_counter()
    for path in jpegs:
        frames[path] = jpeg.read_jpeg(path)
    decode_ms = (time.perf_counter() - start) / len(jpegs) * 1e3
    vga = next(f for f in frames.values() if f.shape == (480, 640, 3))
    start = time.perf_counter()
    for _ in range(20):
        data = jpeg.encode_jpeg(vga)
    encode_ms = (time.perf_counter() - start) / 20 * 1e3
    start = time.perf_counter()
    for _ in range(20):
        jpeg.decode_jpeg(data)
    vga_ms = (time.perf_counter() - start) / 20 * 1e3
    log("fcos_apps", f"the port's JPEG codec on one core: decode {vga_ms:.3f} ms and encode "
        f"{encode_ms:.3f} ms per 480x640 4:2:0 frame (quality 95); {decode_ms:.3f} ms per file "
        f"over the {len(jpegs)} files of both trees")
    try:
        import cv2
    except ImportError:
        log("fcos_apps", "cv2 absent on this host: the codec is held against it only by the "
            "CPU tests")
        return
    buf = np.frombuffer(data, np.uint8)
    start = time.perf_counter()
    for _ in range(20):
        cv2.imdecode(buf, cv2.IMREAD_COLOR)
    cv2_ms = (time.perf_counter() - start) / 20 * 1e3
    differ, worst = 0, 0
    for path, got in frames.items():
        want = cv2.imread(path)
        diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
        differ += int((diff > 0).sum())
        worst = max(worst, int(diff.max()))
    same_bytes = sum(jpeg.encode_jpeg(f) == cv2.imencode(".jpg", f)[1].tobytes()
                     for f in list(frames.values())[:16])
    rng = np.random.default_rng(SEED)
    pairs = [((12, 16), (480, 640)), ((480, 640), (800, 1067)), ((600, 800), (800, 1067)),
             ((17, 33), (5, 7)), ((100, 60), (100, 61))]
    resized = resize_differ = 0
    for (sh, sw), (dh, dw) in pairs:
        src = rng.integers(0, 256, size=(sh, sw, 3)).astype(np.uint8)
        want = cv2.resize(src, (dw, dh))
        resized += want.size
        resize_differ += int((image_io.resize_linear_u8(src, dw, dh) != want).sum())
    log("fcos_apps", f"cv2 {cv2.__version__} on this host (not used by the port): decode of "
        f"{len(frames)} JPEGs, {differ} values differ from cv2.imread (max |diff| {worst}); "
        f"cv2.imdecode of the 480x640 frame {cv2_ms:.3f} ms; "
        f"encode byte-equal to cv2.imencode on {same_bytes} of 16 frames; resize_linear_u8 vs "
        f"cv2.resize: {resize_differ} of {resized} values differ")
    if differ:
        raise AssertionError(f"fcos_apps: the port's JPEG decode differs from cv2.imread in "
                             f"{differ} values (max {worst})")


def gn_backbone_kernels(dev) -> dict:
    """K2s and K2a at the GroupNorm backbone's shapes (``BACKBONE_GN_SHAPES``:
    800x1088, batch 8, G=32, C/G 2 to 16), float32 and bfloat16: K2s to 1e-4
    of scale, two runs bit-equal; K2a bit-equal to its plain version, ReLU on
    and off. Times both (bf16), their plain versions and ``F.group_norm``,
    with their bounds. Returns the per-kernel entries by shape."""
    import torch
    import torch.nn.functional as F

    from handnet_tpu_torch.ops.cuda_gn import (gn_apply, gn_apply_reference, gn_group_stats,
                                               gn_group_stats_reference, group_norm)

    gen = torch.Generator(device=dev).manual_seed(SEED)
    eps, b = 1e-6, TRAIN_BATCH
    out = {"gn_group_stats": [], "gn_apply": []}
    worst = 0.0
    for (h, w, c, g), layers in BACKBONE_GN_SHAPES.items():
        scale = torch.rand(c, device=dev, generator=gen) + 0.5
        bias = torch.randn(c, device=dev, generator=gen)
        x = torch.randn(b, h, w, c, device=dev, generator=gen) * 3 + 2
        for dtype in (torch.float32, torch.bfloat16):
            xd = x.to(dtype)
            name = f"B={b} {h}x{w}x{c} G={g} {dtype}"
            want = gn_group_stats_reference(xd, g)
            tol = 1e-4 * max(1.0, want.abs().max().item())
            stats = same_bits_twice(f"K2s {name}", lambda: gn_group_stats(xd, g))
            worst = max(worst, check(f"K2s {name}", stats, want, tol))
            for relu in (False, True):
                got = gn_apply(xd, stats, scale, bias, eps, relu)
                ref = gn_apply_reference(xd, stats, scale, bias, eps, relu)
                if not torch.equal(got, ref):
                    raise AssertionError(f"K2a {name} relu={relu}: not bit-equal to its plain "
                                         "version")
            if dtype == torch.bfloat16:
                s_t = timed(lambda: gn_group_stats(xd, g))
                a_t = timed(lambda: gn_apply(xd, stats, scale, bias, eps, True))
                s_bound = bound(nbytes(xd) + b * 2 * g * 4, 6 * xd.numel(), F32_FLOPS_PER_S)
                a_bound = bound(2 * nbytes(xd) + nbytes(stats, scale, bias), 4 * xd.numel(),
                                F32_FLOPS_PER_S)
                xc = xd.permute(0, 3, 1, 2)
                plain_s = timed(lambda: gn_group_stats_reference(xd, g))
                plain_a = timed(lambda: gn_apply_reference(xd, stats, scale, bias, eps, True))
                var_mean = timed(lambda: torch.var_mean(xd.view(b, h * w, g, c // g),
                                                        dim=(1, 3), correction=0))
                pair = timed(lambda: group_norm(xd, scale, bias, g, eps, relu=True))
                sc, bi = scale.to(dtype), bias.to(dtype)   # F.group_norm takes x's type
                library = timed(lambda: F.relu(F.group_norm(xc, g, sc, bi, eps)))
                shape = f"B={b} {h}x{w}x{c} G={g} bf16"
                common = {"shape": shape, "layers": layers, "pair_relu_ms": pair["ms"],
                          "pair_relu_library_ms": library["ms"]}
                out["gn_group_stats"].append({**common, **s_t, **s_bound,
                                              "plain_ms": plain_s["ms"],
                                              "library_ms": var_mean["ms"]})
                out["gn_apply"].append({**common, **a_t, **a_bound, "plain_ms": plain_a["ms"],
                                        "library_ms": None})
                log("fcos_apps", f"backbone GN {shape} ({layers} layers): K2s {s_t['ms']:.4f} ms "
                    f"on the device (bound {s_bound['bound_ms']:.4f}, plain "
                    f"{plain_s['ms']:.4f}, torch.var_mean {var_mean['ms']:.4f}), K2a+ReLU "
                    f"{a_t['ms']:.4f} ms (bound {a_bound['bound_ms']:.4f}, plain "
                    f"{plain_a['ms']:.4f}); K2s+K2a+ReLU {pair['ms']:.4f} vs "
                    f"F.relu(F.group_norm) {library['ms']:.4f} ms")
            del xd, stats, want
        del x
    log("fcos_apps", f"backbone GN shapes x f32/bf16: K2s max|err| {worst:.3e} (tol 1e-4 of "
        "scale), two runs bit-equal; K2a bit-equal to its plain version, ReLU on and off")
    return out


def fcos_loader_contention(dev, source, cfg) -> None:
    """``FCOSTrainer.train_step`` at the recipe on one device batch of
    ``source``, 5 steps alone and 5 while ``FCOS_APPS_WORKERS`` loader
    threads decode its frames (host clock; each step ends in reading its
    loss): what the loader's threads cost the thread that launches the step."""
    import threading

    import torch

    from handnet_tpu_torch.apps import train_fcos
    from handnet_tpu_torch.config import TrainConfig
    from handnet_tpu_torch.data.loader import PrefetchLoader, collate_stack
    from handnet_tpu_torch.train.trainer import FCOSTrainer

    trainer = FCOSTrainer(cfg, TrainConfig(batch_size=TRAIN_BATCH, lr=TRAIN_LR,
                                           optimizer="sgd", warmup_epochs=1),
                          backbone_norm="batch", device=dev)
    state = trainer.init_state(SEED)
    host = train_fcos.pinned(dev)(collate_stack([source[i] for i in range(TRAIN_BATCH)]))
    batch = train_fcos.device_batch(host, state.model, cfg, dev)

    def steps(n: int) -> float:
        start = time.perf_counter()
        for _ in range(n):
            trainer.train_step(state, batch)[1]["total_loss"].item()
        return (time.perf_counter() - start) / n * 1e3

    steps(TRAIN_WARM_STEPS)
    alone = steps(5)
    stop = threading.Event()
    built = []

    def drain():
        loader = PrefetchLoader(source, TRAIN_BATCH, shuffle=True,
                                num_workers=FCOS_APPS_WORKERS)
        while not stop.is_set():
            for _ in loader:
                built.append(1)
                if stop.is_set():
                    return

    feeder = threading.Thread(target=drain, daemon=True)
    feeder.start()
    time.sleep(0.5)
    beside = steps(5)
    stop.set()
    feeder.join()
    log("fcos_apps", f"a train step at batch {TRAIN_BATCH}, {cfg.image_h}x{cfg.image_w} bf16, on "
        f"one device batch: {alone:.3f} ms alone, {beside:.3f} ms while {FCOS_APPS_WORKERS} "
        f"loader threads decode frames ({len(built)} batches built meanwhile; host clock, each "
        "step reads its loss)")
    del trainer, state, batch


def log_epochs(tag: str, res: dict) -> None:
    for e in res["epochs"]:
        log("fcos_apps", f"{tag} epoch {e['epoch']}: {e['steps']} steps of batch "
            f"{TRAIN_BATCH}, {e['ms_per_step']:.3f} ms per step, {e['images_per_s']:.2f} "
            f"images/s, {100 * e['loader_wait_share']:.2f}% of the epoch waiting on the loader "
            f"({e['seconds']:.3f} s; loop clock), mean loss {e['losses']['total_loss']:.4f}")


def detection_rows(folder: str) -> dict:
    import os

    rows = {}
    for name in ("comp4_det_test_hand.txt", "comp4_det_test_targetobject.txt"):
        with open(os.path.join(folder, name)) as f:
            rows[name] = [line.split() for line in f.read().splitlines()]
    return rows


def matched_box_diff(got: list, want: list) -> tuple:
    """Match each row of ``got`` with one of ``want`` (same image, state and
    side, the nearest box) and return (rows unmatched, largest box diff in
    px, largest score diff) over the matched ones."""
    import numpy as np

    left, unmatched, worst_box, worst_score = list(want), 0, 0.0, 0.0
    for row in got:
        cands = [(float(np.abs(np.array(a[2:6], float) - np.array(row[2:6], float)).max()), i)
                 for i, a in enumerate(left)
                 if (a[0], a[6], a[9]) == (row[0], row[6], row[9])]
        if not cands:
            unmatched += 1
            continue
        diff, i = min(cands)
        worst_box = max(worst_box, diff)
        worst_score = max(worst_score, abs(float(left[i][1]) - float(row[1])))
        left.pop(i)
    return unmatched, worst_box, worst_score


def eval_detect_kernels_vs_plain(dev, ckpt: str, ds) -> dict:
    """``eval_fcos``'s detector (``build_system`` on ``ckpt``, its
    convolutions back in float32, TF32 off) on the CLI's first batch of
    ``ds``, with K2s/K2a and with their plain versions: the valid
    detections must be the same ones with the same labels, their boxes
    within ``FCOS_EVAL_BOX_TOL`` px. Returns the count and the largest box
    and score differences."""
    import argparse

    import numpy as np
    import torch
    import torch.nn as nn

    from handnet_tpu_torch.apps import eval_fcos
    from handnet_tpu_torch.config import FCOSConfig
    from handnet_tpu_torch.data.image_io import imread_color

    cfg = FCOSConfig(num_classes=3, image_h=FCOS_APPS_IMAGE[0], image_w=FCOS_APPS_IMAGE[1],
                     score_thresh=FCOS_APPS_EVAL_THRESH)
    system = eval_fcos.build_system(argparse.Namespace(torch_checkpoint=ckpt), cfg, dev)
    for m in system.modules():
        if isinstance(m, nn.Conv2d):
            m.to(dtype=torch.float32)
    frames = np.stack([imread_color(ds.image_path(i))[:, :, ::-1].astype(np.float32) / 255.0
                       for i in ds.image_index[:FCOS_APPS_EVAL_BATCH]])
    images = torch.from_numpy(frames).to(dev)
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    det = {}
    with torch.no_grad():
        for on in (True, False):
            for m in system.modules():
                if hasattr(m, "use_kernel"):
                    m.use_kernel = on
            reset_launch_counts()
            det[on] = {k: v.float().cpu() for k, v in system.detect(images).items()}
            if launch_counts()["gn_apply"] != (GN_LAYERS_PER_CALL if on else 0):
                raise AssertionError(f"eval detect: K2a launches {launch_counts()} with "
                                     f"kernels {on}")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    got, want = det[True], det[False]
    valid = want["valid"].bool()
    if not torch.equal(got["valid"], want["valid"]) or not torch.equal(
            got["labels"][valid], want["labels"][valid]):
        raise AssertionError("eval detect: kernels and plain keep other detections")
    if not valid.any():
        raise AssertionError("eval detect: no valid detection to compare")
    box = (got["boxes"][valid] - want["boxes"][valid]).abs().max().item()
    score = (got["scores"][valid] - want["scores"][valid]).abs().max().item()
    if not box <= FCOS_EVAL_BOX_TOL:
        raise AssertionError(f"eval detect: {int(valid.sum())} valid detections, boxes "
                             f"{box} px apart (tol {FCOS_EVAL_BOX_TOL})")
    return {"valid": int(valid.sum()), "box": box, "score": score}


def phase_fcos_apps(dev, work: str, device_arg: str = "cuda") -> dict:
    """The FCOS apps on the card through their entry points: the port's
    synthetic DexYCB tree with colour and a VOC tree, the codec against
    cv2, ``train_fcos.main`` at the recipe, ``train_fcos.main --voc-root``
    with a GroupNorm backbone, ``eval_fcos.main`` with the first run's
    weights, ``train_a2j.main --rgbd``; and K2s/K2a at the GroupNorm
    backbone's shapes. Returns the launches per step and per call of each
    path. ``device_arg`` is the apps' ``--device`` (a CPU rehearsal at tiny
    sizes passes ``cpu``). The trees go under the directory ``work``, where
    ``[rcnn]`` reads them after this phase."""
    import contextlib
    import glob
    import io
    import os
    from unittest import mock

    import numpy as np
    import torch

    from handnet_tpu_torch.apps import eval_fcos, train_a2j, train_fcos
    from handnet_tpu_torch.config import FCOSConfig
    from handnet_tpu_torch.data.detect_data import DetectDataSource
    from handnet_tpu_torch.data.dexycb import DexYCBDataset, refine_indices
    from handnet_tpu_torch.data.synthetic import make_synthetic_dexycb
    from handnet_tpu_torch.data.voc100doh import VOC100DOH, VOCDetectSource
    from handnet_tpu_torch.nn.resnet import GroupNorm

    paths = {}
    shapes = gn_backbone_kernels(dev)
    free_device_memory(dev)
    root, voc = os.path.join(work, "tree"), os.path.join(work, "voc")
    start = time.perf_counter()
    make_synthetic_dexycb(root, n_sequences=FCOS_APPS_SEQUENCES, n_frames=4)
    tree_s = time.perf_counter() - start
    start = time.perf_counter()
    n_voc = write_voc_tree(voc, root, SEED)
    log("fcos_apps", f"synthetic tree ({FCOS_APPS_SEQUENCES} sequences x 4 frames, 480x640, "
        f"colour JPEGs written by the port) in {tree_s:.2f} s; VOC tree of {n_voc} JPEGs "
        f"(the tree's first {FCOS_APPS_VOC_PER_SIZE} frames at each of "
        f"{FCOS_APPS_VOC_SIZES}, hand and object annotated) in "
        f"{time.perf_counter() - start:.2f} s")
    codec_checks(sorted(glob.glob(f"{root}/**/color_*.jpg", recursive=True))
                 + sorted(glob.glob(f"{voc}/**/*.jpg", recursive=True)))

    # train_fcos on the synthetic tree at the recipe, batch-norm backbone
    out = os.path.join(work, "fcos")
    reset_launch_counts()
    res = train_fcos.main(["--data-dir", root, "--synthetic", str(FCOS_APPS_SEQUENCES),
                           "--epochs", str(FCOS_APPS_EPOCHS), "--batch", str(TRAIN_BATCH),
                           "--workers", str(FCOS_APPS_WORKERS), "--backbone-norm", "batch",
                           "--image-h", str(FCOS_APPS_IMAGE[0]), "--image-w",
                           str(FCOS_APPS_IMAGE[1]), "--output", out, "--device", device_arg])
    torch.cuda.synchronize()
    launches = launch_counts()
    steps = sum(e["steps"] for e in res["epochs"])
    want = {**{k: 0 for k in launches}, "gn_group_stats": GN_LAYERS_PER_CALL * steps,
            "gn_apply": GN_LAYERS_PER_CALL * steps}
    log_epochs("train_fcos", res)
    losses = [e["losses"] for e in res["epochs"]]
    if launches != want or not all(np.isfinite(list(l.values())).all() for l in losses):
        raise AssertionError(f"train_fcos: launches {launches} over {steps} steps (expected "
                             f"{want}), losses {losses}")
    log("fcos_apps", f"train_fcos: {res['samples']} samples, {steps} steps, launches "
        f"{launches}: K2s/K2a {GN_LAYERS_PER_CALL} per step, nothing else; losses finite")
    paths["train_fcos_app"] = per_call(launches, steps)
    # the model, reference-keyed, its 23-class logits cut to eval_fcos's 3:
    # background, YCB object 1 as "targetobject" and the hand (22) as "hand"
    state_dict = {k: v.detach().float().cpu()
                  for k, v in res["state"].model.state_dict().items()}
    for k in ("head.classification_head.cls_logits.weight",
              "head.classification_head.cls_logits.bias"):
        state_dict[k] = state_dict[k][[0, 1, 22]].clone()
    ckpt = os.path.join(work, "fcos_synthetic.pth")
    torch.save({"model": state_dict}, ckpt)
    del res
    free_device_memory(dev)
    ds = DexYCBDataset("s0", "train", root)
    fcos_loader_contention(dev, DetectDataSource(ds, refine_indices(ds), e2e=True,
                                                 uint8_images=True),
                           FCOSConfig(num_classes=23, image_h=FCOS_APPS_IMAGE[0],
                                      image_w=FCOS_APPS_IMAGE[1]))
    free_device_memory(dev)
    cfg = FCOSConfig(num_classes=3, image_h=FCOS_APPS_IMAGE[0], image_w=FCOS_APPS_IMAGE[1])

    # train_fcos --voc-root with a GroupNorm backbone: 36 more K2s/K2a a step
    reset_launch_counts()
    res = train_fcos.main(["--voc-root", voc, "--epochs", "1", "--batch", str(TRAIN_BATCH),
                           "--workers", str(FCOS_APPS_WORKERS), "--backbone-norm", "group",
                           "--image-h", str(FCOS_APPS_IMAGE[0]), "--image-w",
                           str(FCOS_APPS_IMAGE[1]), "--output", os.path.join(work, "fcos_voc"),
                           "--device", device_arg])
    torch.cuda.synchronize()
    launches = launch_counts()
    steps = res["epochs"][0]["steps"]
    per_step = GN_LAYERS_PER_CALL + BACKBONE_GN_LAYERS
    want = {**{k: 0 for k in launches}, "gn_group_stats": per_step * steps,
            "gn_apply": per_step * steps}
    log_epochs("train_fcos --voc-root --backbone-norm group", res)
    if launches != want or not np.isfinite(res["epochs"][0]["losses"]["total_loss"]):
        raise AssertionError(f"train_fcos --voc-root: launches {launches} over {steps} steps "
                             f"(expected {want}), losses {res['epochs'][0]['losses']}")
    paths["train_fcos_voc_group"] = per_call(launches, steps)
    # the trained backbone's GroupNorms: kernels against plain versions on one batch
    model = res["state"].model.eval()
    body = model.backbone["body"]
    gns = [m for m in body.modules() if isinstance(m, GroupNorm)]
    src = VOCDetectSource(VOC100DOH(voc), target_size=(cfg.image_h, cfg.image_w))
    images = torch.from_numpy(np.stack([src[i]["image"] for i in range(TRAIN_BATCH)])).to(dev)
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    feats = {}
    with torch.no_grad():
        net = model.preprocess(images)[0].permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        for on in (True, False):
            for m in gns:
                m.use_kernel = on
            reset_launch_counts()
            feats[on] = body(net)
            counted = launch_counts()["gn_group_stats"]
            if counted != (len(gns) if on else 0):
                raise AssertionError(f"backbone GN: {counted} K2s launches with kernels {on}")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    errs = {k: ((feats[True][k] - feats[False][k]).abs().max()
                / feats[False][k].abs().max()).item() for k in feats[False]}
    if len(gns) != BACKBONE_GN_LAYERS or not max(errs.values()) <= FCOS_BACKBONE_GN_TOL:
        raise AssertionError(f"backbone GN kernels vs plain: {len(gns)} layers, {errs}")
    log("fcos_apps", f"train_fcos --voc-root, GroupNorm backbone: {steps} steps, K2s/K2a "
        f"{per_step} per step ({GN_LAYERS_PER_CALL} head + {BACKBONE_GN_LAYERS} backbone), "
        f"nothing else; the trained backbone's {len(gns)} GroupNorms on one batch, f32 TF32 "
        f"off, kernels vs plain: " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
        + f" of each level's scale (tol {FCOS_BACKBONE_GN_TOL:g})")
    del res, model, body, gns, feats, images, net
    free_device_memory(dev)

    # eval_fcos on the VOC tree with the synthetic run's weights: twice
    # with kernels (launches, FPS), once with the plain GroupNorm (bf16:
    # printed); then detect itself, kernels vs plain, in float32
    args = ["--voc-root", voc, "--image-set", "trainval", "--torch-checkpoint", ckpt,
            "--batch", str(FCOS_APPS_EVAL_BATCH), "--image-h", str(FCOS_APPS_IMAGE[0]),
            "--image-w", str(FCOS_APPS_IMAGE[1]), "--score-thresh",
            str(FCOS_APPS_EVAL_THRESH), "--device", device_arg]
    calls = n_voc // FCOS_APPS_EVAL_BATCH
    runs = []
    for i in range(2):
        text = io.StringIO()
        reset_launch_counts()
        with contextlib.redirect_stdout(text):
            results = eval_fcos.main(args + ["--output", os.path.join(work, f"eval{i}")])
        torch.cuda.synchronize()
        launches = launch_counts()
        fps = float(re.search(r"FPS: ([0-9.]+)", text.getvalue()).group(1))
        runs.append((results, fps))
        want = {**{k: 0 for k in launches}, "gn_group_stats": GN_LAYERS_PER_CALL * calls,
                "gn_apply": GN_LAYERS_PER_CALL * calls}
        if launches != want or not all(np.isfinite(v) for v in results.values()):
            raise AssertionError(f"eval_fcos: launches {launches} (expected {want}), "
                                 f"results {results}")
    paths["eval_fcos"] = per_call(launches, calls)
    real_build = eval_fcos.build_system

    def plain_build(*a, **k):
        system = real_build(*a, **k)
        for m in system.modules():
            if hasattr(m, "use_kernel"):
                m.use_kernel = False
        return system

    with mock.patch.object(eval_fcos, "build_system", plain_build), \
            contextlib.redirect_stdout(io.StringIO()):
        plain = eval_fcos.main(args + ["--output", os.path.join(work, "eval_plain")])
    # and with no checkpoint: the CLI's random weights (seed 0)
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        random_results = eval_fcos.main([a for a in args if a not in ("--torch-checkpoint",
                                                                      ckpt)]
                                        + ["--output", os.path.join(work, "eval_random")])
    if "WARNING: random detector weights" not in text.getvalue():
        raise AssertionError("eval_fcos without a checkpoint: no random-weights warning")
    rows, plain_rows = detection_rows(os.path.join(work, "eval0")), detection_rows(
        os.path.join(work, "eval_plain"))
    random_rows = detection_rows(os.path.join(work, "eval_random"))
    # every row of both files has its 11 fields; the files together hold
    # rows (a detector trained 16 steps may rank one class first everywhere)
    fields = {len(r) for rs in (*rows.values(), *random_rows.values()) for r in rs}
    if (fields - {11} or not any(rows.values())
            or not all(np.isfinite(v) for v in random_results.values())):
        raise AssertionError(f"eval_fcos: fields {fields}, rows "
                             f"{ {n: len(r) for n, r in rows.items()} }, with random "
                             f"weights { {n: len(r) for n, r in random_rows.items()} }")
    compared = {name: matched_box_diff(rows[name], plain_rows[name]) for name in rows}
    log("fcos_apps", f"eval_fcos over {n_voc} frames at batch {FCOS_APPS_EVAL_BATCH}: "
        f"{ {n: len(r) for n, r in rows.items()} } 11-field rows; AP "
        + ", ".join(f"{k} {v:.4f}" for k, v in runs[-1][0].items())
        + f" (finite); FPS {runs[0][1]:.2f} and {runs[1][1]:.2f} (detect between CUDA "
        f"events); K2s/K2a {GN_LAYERS_PER_CALL} per call, nothing else. The CLI with the "
        f"plain GroupNorm (bf16): rows { {n: len(r) for n, r in plain_rows.items()} }, "
        "against the kernels' (unmatched rows, max box diff px, max score diff): "
        + ", ".join(f"{n.split('_')[-1][:-4]} {c[0]}, {c[1]:.3e}, {c[2]:.3e}"
                    for n, c in compared.items()) + f"; AP {plain}. Without a checkpoint "
        f"(random weights): rows { {n: len(r) for n, r in random_rows.items()} }, every "
        "row 11 fields, AP finite")
    frame_diff = eval_detect_kernels_vs_plain(dev, ckpt, VOC100DOH(voc, "trainval"))
    log("fcos_apps", "eval_fcos's detect on its first batch in float32 (TF32 off), "
        f"kernels vs the plain GroupNorm: {frame_diff['valid']} valid detections, the same "
        f"ones, labels equal; boxes max |diff| {frame_diff['box']:.3e} px (tol "
        f"{FCOS_EVAL_BOX_TOL:g}), scores {frame_diff['score']:.3e}")
    free_device_memory(dev)

    # train_a2j --rgbd on the colour tree: one epoch at the recipe
    reset_launch_counts()
    res = train_a2j.main(["--data-dir", root, "--synthetic", str(FCOS_APPS_SEQUENCES),
                          "--rgbd", "--crop", str(A2J_APPS_CROP), "--batch",
                          str(A2J_TRAIN_BATCH), "--epochs", "1", "--eval-every", "1",
                          "--workers", str(A2J_APPS_WORKERS), "--output",
                          os.path.join(work, "a2j_rgbd"), "--device", device_arg])
    torch.cuda.synchronize()
    launches = launch_counts()
    sweep = res["evals"][-1]
    n_test, batches = sweep["samples"], sweep["batches"]
    want = {**{k: 0 for k in launches},
            "a2j_decode": math.ceil(n_test / A2J_TRAIN_BATCH)}
    if (launches != want or batches != want["a2j_decode"]
            or not np.isfinite(res["epochs"][0]["losses"]["total_loss"])
            or res["state"].model.cfg.in_channels != 4):
        raise AssertionError(f"train_a2j --rgbd: launches {launches} (expected {want}), "
                             f"losses {res['epochs'][0]['losses']}")
    e = res["epochs"][0]
    log("fcos_apps", f"train_a2j --rgbd: {e['steps']} steps of batch {A2J_TRAIN_BATCH} "
        f"(4-channel crops, BGR + depth), {e['ms_per_step']:.3f} ms per step, "
        f"{e['samples_per_s']:.1f} samples/s, {100 * e['loader_wait_share']:.2f}% waiting "
        f"on the loader, mean loss {e['losses']['total_loss']:.4f} (finite); eval sweep of "
        f"{n_test} samples: K1 {launches['a2j_decode']} = ceil({n_test} / "
        f"{A2J_TRAIN_BATCH}), nothing else")
    paths["train_a2j_rgbd_eval"] = per_call(launches, batches)
    del res
    free_device_memory(dev)
    return {"paths": paths, "shapes": shapes}


def rcnn_train_cli(tag: str, argv: list, per_step_gn: int) -> tuple:
    """``train_fcos.main(argv)`` with the launch counts from 0 and the peak
    device memory: checks that K2s/K2a launched ``per_step_gn`` times per
    step and nothing else did, and that every epoch's mean loss is finite
    (``main`` itself exits at the first step whose loss is not). Returns
    ``(result, launches per step)``."""
    import numpy as np
    import torch

    from handnet_tpu_torch.apps import train_fcos

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    res = train_fcos.main(argv)
    torch.cuda.synchronize()
    launches = launch_counts()
    steps = sum(e["steps"] for e in res["epochs"])
    want = {**{k: 0 for k in launches}, "gn_group_stats": per_step_gn * steps,
            "gn_apply": per_step_gn * steps}
    losses = [e["losses"] for e in res["epochs"]]
    if launches != want or not all(np.isfinite(list(l.values())).all() for l in losses):
        raise AssertionError(f"{tag}: launches {launches} over {steps} steps (expected {want}), "
                             f"losses {losses}")
    for e in res["epochs"]:
        log("rcnn", f"{tag} epoch {e['epoch']}: {e['steps']} steps of batch {TRAIN_BATCH}, "
            f"{e['ms_per_step']:.3f} ms per step, {e['images_per_s']:.2f} images/s, "
            f"{100 * e['loader_wait_share']:.2f}% waiting on the loader (loop clock), mean "
            "losses " + ", ".join(f"{k} {v:.4f}" for k, v in e["losses"].items()))
    log("rcnn", f"{tag}: {res['samples']} samples, {steps} steps, every step's loss finite; "
        f"launches {launches}: K2s/K2a {per_step_gn} per step, nothing else; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return res, per_call(launches, steps)


def rcnn_gn_kernels_vs_plain(dev, model, images) -> dict:
    """The trained GroupNorm-backbone R-CNN on one batch at 800x1088 in
    float32 (TF32 off): the pyramid P2-P6 and the RPN objectness with
    K2s/K2a against the same with the plain GroupNorm, each level's max
    |diff| over its max |value| within ``FCOS_BACKBONE_GN_TOL``."""
    import torch

    from handnet_tpu_torch.nn.resnet import GroupNorm

    model = model.eval()
    gns = [m for m in model.modules() if isinstance(m, GroupNorm)]
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    outs = {}
    with torch.no_grad():
        net = model.preprocess(images)[0]
        for on in (True, False):
            for m in gns:
                m.use_kernel = on
            reset_launch_counts()
            pyramid = model.features(net)
            obj = model.rpn["head"](pyramid)[0]
            counted = launch_counts()
            if counted["gn_group_stats"] != (len(gns) if on else 0) or counted["gn_apply"] != (
                    len(gns) if on else 0):
                raise AssertionError(f"rcnn GN: launches {counted} with kernels {on}")
            outs[on] = {**{f"P{i + 2}": p.float() for i, p in enumerate(pyramid)},
                        "objectness": obj.float()}
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    errs = {k: ((outs[True][k] - outs[False][k]).abs().max() / outs[False][k].abs().max()).item()
            for k in outs[False]}
    if len(gns) != BACKBONE_GN_LAYERS or not max(errs.values()) <= FCOS_BACKBONE_GN_TOL:
        raise AssertionError(f"rcnn GN kernels vs plain: {len(gns)} layers, {errs}")
    return errs


def rcnn_timings(dev, model, batch, card: str) -> dict:
    """At the recipe's train shape (batch 8, 800x1088, bf16 autocast, 128
    proposals): ``multiscale_roi_align`` with its byte bound (the distinct
    feature rows its taps read, the rois, the float32 output), the RPN's
    ranking and NMS (``select_proposals``) with its kernels per call, and
    the eval forward, each by the kernels' own durations and by a loop of
    calls between events."""
    import torch

    from handnet_tpu_torch.models import faster_rcnn as frcnn

    model = model.eval()
    auto = torch.autocast("cuda", dtype=torch.bfloat16)
    with torch.no_grad(), auto:
        pyramid = model.features(batch["image"])
        raw_obj, raw_reg = model.rpn["head"](pyramid)
        props = model.propose(pyramid)[0]
    levels, strides = pyramid[:4], model.strides[:4]
    out = {}

    def roi_align():
        return frcnn.multiscale_roi_align(levels, props, RCNN_ROI, strides)

    def select():
        return frcnn.select_proposals(raw_obj, raw_reg, model.anchors,
                                      (model.image_h, model.image_w), RCNN_PROPOSALS)

    def forward():
        with torch.no_grad(), auto:
            return model(batch["image"])

    with torch.no_grad():
        pooled = roi_align()
        n_rows = rcnn_tap_rows(levels, props, strides)
        roi_bytes = n_rows * levels[0].shape[1] * levels[0].element_size() + nbytes(props, pooled)
        out["roi_align"] = {**timed(roi_align), **bound(roi_bytes, 0, 1.0), "rows": n_rows}
        out["select"] = {**timed(select), "kernels": kernels_per_call(select)}
        out["forward"] = {"loop_ms": cuda_ms(forward, iters=RCNN_TIMED_STEPS, warmup=2),
                          "ms": device_ms(forward, iters=RCNN_TIMED_STEPS, warmup=1)}
    r, s_, f = out["roi_align"], out["select"], out["forward"]
    log("rcnn", f"multiscale_roi_align at B={TRAIN_BATCH}, R={RCNN_PROPOSALS}, C=256, bf16 "
        f"pyramid, 7x7 bins of 2x2 taps, each roi at its own level: {r['ms']:.4f} ms on the "
        f"device ({r['loop_ms']:.4f} loop), bound {r['bound_ms']:.4f} ms by {r['bound_by']} "
        f"({r['rows']} distinct feature rows, {roi_bytes / 1e6:.1f} MB at 3.35 TB/s), "
        f"{100 * r['bound_ms'] / r['ms']:.1f}% of the bound; {card}")
    log("rcnn", f"select_proposals (decode + clip of {raw_obj.shape[1]} anchors, top "
        f"{RCNN_NMS_CANDIDATES}, a {RCNN_NMS_CANDIDATES}-step NMS, top {RCNN_PROPOSALS}) at "
        f"B={TRAIN_BATCH}: {s_['kernels']} kernels per call, {s_['ms']:.4f} ms on the device "
        f"({s_['loop_ms']:.4f} loop); {card}")
    log("rcnn", f"the eval forward at B={TRAIN_BATCH} bf16: {f['ms']:.3f} ms of kernels "
        f"({f['loop_ms']:.3f} loop); {card}")
    return out


def kernels_per_call(fn) -> int:
    """The kernels that one call of ``fn`` launches on the card
    (torch.profiler's records)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(n for _, _, n in device_rows(prof))


def rcnn_tap_rows(levels, props, strides) -> int:
    """The distinct feature rows (one pixel of one image at one level) that
    ``multiscale_roi_align``'s taps read for ``props [B, R, 4]``: the
    indices it gathers, each counted once."""
    import torch

    from handnet_tpu_torch.models import faster_rcnn as frcnn

    base, hs, ws, scale = frcnn.level_geometry(levels, props, strides)
    taps = frcnn._taps(base, hs, ws, props.reshape(-1, 4), scale, RCNN_ROI, 2)
    return int(torch.unique(torch.cat([idx.reshape(-1) for idx, _ in taps])).numel())


def phase_rcnn(dev, work: str, card: str, device_arg: str = "cuda") -> dict:
    """The Faster R-CNN through its entry points at the 100DOH recipe
    (800x1088, batch 8, bf16, 128 proposals, ResNet-34 + FPN over c2-c5 +
    P6, a 1024-wide TwoMLPHead, 3 classes on VOC): ``train_fcos --net rcnn``
    on ``[fcos_apps]``'s synthetic tree (batch-norm backbone, no launch of
    ours) and on its VOC tree with the GroupNorm backbone (K2s/K2a 36 per
    step), the trained GroupNorm backbone's pyramid and RPN objectness with
    kernels against the plain GroupNorm, a train step alone, ``eval_fcos
    --net rcnn`` from a short frozen-backbone run's reference-keyed
    weights, and the device times of RoIAlign, the RPN's ranking and NMS,
    the forward and a step. Returns the launches per step or call of each
    path."""
    import contextlib
    import io
    import os

    import numpy as np
    import torch

    from handnet_tpu_torch.apps import eval_fcos
    from handnet_tpu_torch.config import FCOSConfig, TrainConfig
    from handnet_tpu_torch.data.voc100doh import VOC100DOH, VOCDetectSource
    from handnet_tpu_torch.train.trainer import RCNNTrainer

    root, voc = os.path.join(work, "tree"), os.path.join(work, "voc")
    common = ["--net", "rcnn", "--num-proposals", str(RCNN_PROPOSALS), "--batch",
              str(TRAIN_BATCH), "--workers", str(FCOS_APPS_WORKERS), "--image-h",
              str(FCOS_APPS_IMAGE[0]), "--image-w", str(FCOS_APPS_IMAGE[1]), "--device", device_arg]
    paths = {}
    res, paths["train_rcnn"] = rcnn_train_cli(
        "train_fcos --net rcnn (batch-norm backbone, synthetic tree)",
        common + ["--data-dir", root, "--synthetic", str(FCOS_APPS_SEQUENCES), "--epochs",
                  str(RCNN_EPOCHS), "--backbone-norm", "batch", "--output",
                  os.path.join(work, "rcnn_batch")], 0)
    # a train step alone at the recipe, on a seeded batch, from the trained state
    cfg = FCOSConfig(num_classes=23, image_h=FCOS_APPS_IMAGE[0], image_w=FCOS_APPS_IMAGE[1])
    trainer = RCNNTrainer(cfg, TrainConfig(batch_size=TRAIN_BATCH, lr=TRAIN_LR, optimizer="sgd",
                                           warmup_epochs=1),
                          backbone_norm="batch", num_proposals=RCNN_PROPOSALS, device=dev)
    state, batch = res["state"], train_batch(dev, cfg, SEED)
    del res
    step = lambda: trainer.train_step(state, batch)[1]["total_loss"]   # noqa: E731
    for _ in range(2):
        step().item()
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(step, iters=RCNN_TIMED_STEPS, warmup=1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    last = step().item()
    if not np.isfinite(last):
        raise AssertionError(f"rcnn step alone: loss {last}")
    log("rcnn", f"a train step alone at batch {TRAIN_BATCH}, {cfg.image_h}x{cfg.image_w} bf16, "
        f"{RCNN_PROPOSALS} proposals: {step_ms:.3f} ms (CUDA events over "
        f"{RCNN_TIMED_STEPS} steps), peak device memory {peak:.2f} GiB, loss {last:.4f}; {card}")
    train_step_profile(trainer, state, batch, "rcnn")
    timings = rcnn_timings(dev, state.model, batch, card)
    del state, batch, trainer
    free_device_memory(dev)

    res, paths["train_rcnn_voc_group"] = rcnn_train_cli(
        "train_fcos --net rcnn --voc-root --backbone-norm group",
        common + ["--voc-root", voc, "--epochs", str(RCNN_EPOCHS), "--backbone-norm", "group",
                  "--output", os.path.join(work, "rcnn_group")], BACKBONE_GN_LAYERS)
    src = VOCDetectSource(VOC100DOH(voc), target_size=FCOS_APPS_IMAGE)
    images = torch.from_numpy(np.stack([src[i]["image"] for i in range(TRAIN_BATCH)])).to(dev)
    errs = rcnn_gn_kernels_vs_plain(dev, res["state"].model, images)
    log("rcnn", f"the trained GroupNorm backbone on one VOC batch, f32 TF32 off, kernels vs "
        f"plain ({BACKBONE_GN_LAYERS} GroupNorms, K2s/K2a {BACKBONE_GN_LAYERS} each with "
        "kernels, 0 without): " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
        + f" of each one's scale (tol {FCOS_BACKBONE_GN_TOL:g})")
    del res, images
    free_device_memory(dev)

    # eval_fcos --net rcnn from a short frozen-backbone run's weights, reference-keyed
    res, _ = rcnn_train_cli(
        "train_fcos --net rcnn --voc-root --backbone-norm frozen",
        common + ["--voc-root", voc, "--epochs", str(RCNN_FROZEN_EPOCHS), "--backbone-norm",
                  "frozen", "--output", os.path.join(work, "rcnn_frozen")], 0)
    ckpt = os.path.join(work, "rcnn_frozen.pth")
    torch.save({"model": {k: v.detach().cpu() for k, v in
                          res["state"].model.state_dict().items()}}, ckpt)
    del res
    free_device_memory(dev)
    n_voc = len(VOC100DOH(voc, "trainval").image_index)
    calls = math.ceil(n_voc / FCOS_APPS_EVAL_BATCH)
    text = io.StringIO()
    reset_launch_counts()
    with contextlib.redirect_stdout(text):
        results = eval_fcos.main(["--net", "rcnn", "--voc-root", voc, "--image-set", "trainval",
                                  "--torch-checkpoint", ckpt, "--num-proposals",
                                  str(RCNN_PROPOSALS), "--batch", str(FCOS_APPS_EVAL_BATCH),
                                  "--image-h", str(FCOS_APPS_IMAGE[0]), "--image-w",
                                  str(FCOS_APPS_IMAGE[1]), "--score-thresh",
                                  str(FCOS_APPS_EVAL_THRESH), "--device", device_arg,
                                  "--output", os.path.join(work, "rcnn_eval")])
    torch.cuda.synchronize()
    launches = launch_counts()
    fps = float(re.search(r"FPS: ([0-9.]+)", text.getvalue()).group(1))
    rows = detection_rows(os.path.join(work, "rcnn_eval"))
    fields = {len(r) for rs in rows.values() for r in rs}
    if (any(launches.values()) or fields - {11} or not any(rows.values())
            or not all(np.isfinite(v) for v in results.values())):
        raise AssertionError(f"eval_fcos --net rcnn: launches {launches}, fields {fields}, rows "
                             f"{ {n: len(r) for n, r in rows.items()} }, results {results}")
    paths["eval_rcnn"] = per_call(launches, calls)
    firsts = "; ".join(" ".join(r[:6]) for rs in rows.values() for r in rs[:2])
    log("rcnn", f"eval_fcos --net rcnn over {n_voc} frames at batch {FCOS_APPS_EVAL_BATCH}: "
        f"{ {n: len(r) for n, r in rows.items()} } 11-field rows (first: {firsts}); AP "
        + ", ".join(f"{k} {v:.4f}" for k, v in results.items())
        + f" (finite); FPS {fps:.2f} (detect between CUDA events); no launch of ours; {card}")
    free_device_memory(dev)
    return {"paths": paths, "timings": {**timings, "step_ms": step_ms, "peak_gib": peak}}


# --- the demo apps: demo, a2j_mesh, the ROS node's core, a2j_infer --vis, statepack ---

# the trained models of [train] and [train_a2j] (on the host, with their
# configs), which [demo_apps] packs with utils/statepack.py
TRAINED: dict = {}


def device_sync(dev) -> None:
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def save_reference_checkpoints(demo, work: str) -> list:
    """Seed-2 weights of the demo's pipeline at its default geometry,
    written as reference-keyed FCOS and A2J checkpoints; returns the
    demo's ``--fcos-checkpoint``/``--a2j-checkpoint`` arguments."""
    import os

    import torch

    from handnet_tpu_torch.models.pipeline import HandNetPipeline

    cfg = demo.build_config(demo.parse_args(["--a2j-checkpoint", "a2j.pth"]))
    state = HandNetPipeline(cfg, seed=SEED, device="cpu").state_dict()
    args = []
    for part, flag in (("detector", "--fcos-checkpoint"), ("a2j", "--a2j-checkpoint")):
        path = os.path.join(work, f"{part}.pth")
        torch.save({k[len(part) + 1:]: v for k, v in state.items()
                    if k.startswith(part + ".")}, path)
        args += [flag, path]
    return args


def demo_runs(dev, demo, work: str, ckpt: list, device_arg: str) -> dict:
    """``demo.main`` on the synthetic source at the default geometry (bf16,
    score threshold 0), then with ``--flip-left --render-mesh``; the
    float32 forward built as the demo builds it, kernels against plain
    versions. Returns the launches per frame."""
    import os

    import numpy as np
    import torch

    from handnet_tpu_torch.ops.geometry import convert_joints

    base = ["--score-thresh", "0", "--device", device_arg] + ckpt
    os.makedirs(os.path.join(work, "demo"))
    reset_launch_counts()
    res = demo.main(base + ["--frames", str(DEMO_FRAMES), "--out",
                            os.path.join(work, "demo", "res.npz")])
    device_sync(dev)
    launches = launch_counts()
    want = expected_launches(DEMO_FRAMES, GN_LAYERS_PER_CALL)
    finite = all(np.isfinite(r["joints_uvd"]).all() and np.isfinite(r["joints_xyz"]).all()
                 for r in res["results"])
    if launches != want or res["found"] != DEMO_FRAMES or not finite:
        raise AssertionError(f"demo: launches {launches} (expected {want}), found "
                             f"{res['found']}/{DEMO_FRAMES}, finite {finite}")
    log("demo_apps", f"demo.main, synthetic 480x640 into the default 800x1088 geometry, bf16, "
        f"B=1: {DEMO_FRAMES} frames, all found, joints finite; launches {launches} (K2s/K2a "
        f"{GN_LAYERS_PER_CALL} and K1 1 per frame, nothing else); steady state "
        f"{res['fps']:.2f} frames/s, {res['ms_per_frame']:.3f} ms per frame (host clock, each "
        "frame from the call until the card has finished it)")

    mesh_dir = os.path.join(work, "demo_mesh")
    reset_launch_counts()
    res = demo.main(base + ["--frames", str(DEMO_MESH_FRAMES), "--flip-left", "--render-mesh",
                            "--out", os.path.join(mesh_dir, "res.npz")])
    device_sync(dev)
    mesh_launches = launch_counts()
    want = expected_launches(DEMO_MESH_FRAMES, GN_LAYERS_PER_CALL)
    paras = torch.tensor([[600.0, 600.0, 320.0, 240.0]])
    found = [i for i, r in enumerate(res["results"]) if r["found"]]
    overlays = sorted(f for f in os.listdir(mesh_dir) if f.startswith("overlay_"))
    err = 0.0
    for i in found:
        r = res["results"][i]
        if r["mesh"].shape != (MESH_VERTS, 3) or not np.isfinite(r["mesh"]).all():
            raise AssertionError(f"demo --render-mesh: frame {i} mesh {r['mesh'].shape}")
        xyz = convert_joints(torch.from_numpy(r["joints_uvd"][None]),
                             torch.from_numpy(r["box"][None]), paras, 176, 176)[0]
        err = max(err, check(f"demo --flip-left frame {i} xyz", torch.from_numpy(
            r["joints_xyz"]), xyz, 1e-3))
    if (mesh_launches != want or overlays != [f"overlay_{i:04d}.png" for i in found]
            or len(found) != DEMO_MESH_FRAMES):
        raise AssertionError(f"demo --flip-left --render-mesh: launches {mesh_launches}, found "
                             f"{found}, overlays {overlays}")
    log("demo_apps", f"demo.main --flip-left --render-mesh: {DEMO_MESH_FRAMES} frames, all "
        f"found, one overlay_NNNN.png each, a finite [{MESH_VERTS}, 3] mesh each, xyz == "
        f"convert_joints of the saved uvd and box (max |err| {err:.3e} mm); launches "
        f"{mesh_launches}; the host's overlay (raster + PNG) {res['overlay_ms']:.3f} ms per "
        f"frame; {res['ms_per_frame']:.3f} ms per frame on the card")

    # float32, TF32 off: the demo's forward with kernels against plain versions
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    args = demo.parse_args(base)
    rgb, depth = zip(*demo.SyntheticSource(2, seed=1).frames())
    frames = (torch.from_numpy(np.stack(rgb)).to(dev), torch.from_numpy(np.stack(depth)).to(dev),
              paras.repeat(2, 1).to(dev))
    outs = [demo.build_pipeline(args, dev, torch.float32, use_kernels=k)(*frames)
            for k in (True, False)]
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    err = compare_outputs("demo f32 kernels vs plain", outs[0], outs[1], DEMO_TOL)
    log("demo_apps", f"the demo's pipeline in float32 (TF32 off), 2 frames: the kernel path == "
        f"the plain path on found/sides/boxes/crops, joints max |err| {err:.3e} (tol "
        f"{DEMO_TOL:g} px, {10 * DEMO_TOL:g} mm)")
    return per_call(launches, DEMO_FRAMES)


def demo_folder(dev, demo, work: str, tree: str, ckpt: list, device_arg: str) -> None:
    """``FolderSource`` over 8 colour/depth pairs of the synthetic tree:
    where cv2 imports, its frames == ``cv2.imread``'s (the JAX app's
    reads); then ``demo.main --source folder`` over them."""
    import glob
    import os

    import numpy as np
    import torch

    folder = os.path.join(work, "frames")
    os.makedirs(folder)
    colors = sorted(glob.glob(os.path.join(tree, "**", "color_*.jpg"), recursive=True))
    for i, color in enumerate(colors[:DEMO_FOLDER_FRAMES]):
        os.symlink(color, os.path.join(folder, f"color_{i:04d}.jpg"))
        os.symlink(color.replace("color_", "aligned_depth_to_color_").replace(".jpg", ".png"),
                   os.path.join(folder, f"depth_{i:04d}.png"))
    frames = list(demo.FolderSource(folder).frames())
    try:
        import cv2
    except ImportError:
        log("demo_apps", "FolderSource: cv2 is not installed, its reads are not compared")
    else:
        src = demo.FolderSource(folder)
        for (rgb, depth), c, d in zip(frames, src.colors, src.depths):
            if not (np.array_equal(rgb, cv2.imread(c)[:, :, ::-1].astype(np.float32) / 255.0)
                    and np.array_equal(depth, cv2.imread(d, cv2.IMREAD_ANYDEPTH).astype(
                        np.float32) / 1000.0)):
                raise AssertionError(f"FolderSource: {c} or {d} differs from cv2.imread")
        log("demo_apps", f"FolderSource: {len(frames)} colour/depth pairs of the synthetic tree "
            f"== cv2 {cv2.__version__}'s imread (RGB/255, depth mm/1000), bit for bit")
    reset_launch_counts()
    res = demo.main(["--source", "folder", "--input", folder, "--score-thresh", "0",
                     "--device", device_arg] + ckpt)
    device_sync(dev)
    launches = launch_counts()
    n = len(res["results"])
    finite = all(np.isfinite(r["joints_xyz"]).all() for r in res["results"])
    if n != DEMO_FOLDER_FRAMES or not finite or launches != expected_launches(
            n, GN_LAYERS_PER_CALL):
        raise AssertionError(f"demo --source folder: {n} frames, finite {finite}, launches "
                             f"{launches}")
    log("demo_apps", f"demo.main --source folder: {n} frames, {res['found']} found, joints "
        f"finite; launches {launches}")


def a2j_mesh_run(dev, a2j_mesh, work: str, a2j_ckpt: str, device_arg: str) -> dict:
    """``a2j_mesh.main --synthetic 4 --limit 8``: K1 once per sample, and
    nothing else; finite joints and meshes under the JAX app's keys."""
    import os

    import numpy as np
    import torch

    reset_launch_counts()
    start = time.perf_counter()
    got = a2j_mesh.main(["--synthetic", "4", "--data-dir", os.path.join(work, "mesh_tree"),
                         "--limit", str(A2J_MESH_SAMPLES), "--a2j-checkpoint", a2j_ckpt,
                         "--out", os.path.join(work, "meshes.npz"), "--device", device_arg])
    device_sync(dev)
    seconds = time.perf_counter() - start
    launches = launch_counts()
    n = A2J_MESH_SAMPLES
    keys = {f"sample{i}_{k}" for i in range(n) for k in ("joints_xyz", "mesh")}
    saved = np.load(os.path.join(work, "meshes.npz"))
    ok = (set(got) == set(saved.files) == keys
          and all(got[f"sample{i}_joints_xyz"].shape == (21, 3)
                  and got[f"sample{i}_mesh"].shape == (MESH_VERTS, 3) for i in range(n))
          and all(np.isfinite(v).all() for v in got.values()))
    if launches != {**{k: 0 for k in launches}, "a2j_decode": n} or not ok:
        raise AssertionError(f"a2j_mesh: launches {launches}, keys {sorted(got)}")
    log("demo_apps", f"a2j_mesh.main --synthetic 4 --limit {n} (crop 176, float32): {n} finite "
        f"joints [21, 3] and meshes [{MESH_VERTS}, 3] under sample<i>_joints_xyz/_mesh; "
        f"launches {launches} (K1 once per sample); {seconds:.3f} s with the tree and the "
        "builds")
    return per_call(launches, n)


def ros_node_run(dev, ros_node, cfg) -> dict:
    """``HandNetRosNode`` over a started ``PipelineServer`` (fast at
    480x640, bf16, buckets 1/8/128, seed-2 weights): 32 pairs, 16UC1 and
    32FC1 in turns with depth stamps inside the 0.1 s slop, and one pair
    outside it. Each paired frame is published once with its stamp,
    ``joints_xyz`` == ``convert_joints`` of the payload, and the payloads ==
    the eager forward of the dispatches' padded wire batches within
    ``DEMO_TOL`` px. Returns the launches per eager call of the capture."""
    import numpy as np
    import torch

    from handnet_tpu_torch.graphs import WARMUP_CALLS
    from handnet_tpu_torch.models.pipeline import HandNetPipeline
    from handnet_tpu_torch.ops.geometry import convert_joints

    frame_hw = (480, 640)
    server = serving_server(cfg, dev, HandNetPipeline(cfg, dtype=cfg_dtype(dev), device=dev,
                                                      seed=SEED).state_dict(),
                            SERVE_BUCKETS, frame_hw)
    reset_launch_counts()
    server.start()
    device_sync(dev)
    # the warm-up and capture calls of each bucket (none on the CPU)
    calls = (WARMUP_CALLS + 1) * len(SERVE_BUCKETS) if dev.type == "cuda" else 0
    capture = launch_counts()
    if capture != expected_launches(calls, GN_LAYERS_PER_CALL):
        raise AssertionError(f"ros_node: the server's capture launched {capture} in {calls} calls")
    dispatches = []
    dispatch = server._dispatch

    def recording(items):   # the wire frames of each dispatch, and its bucket
        out = dispatch(items)
        bucket = next(b for b in server.batch_buckets if b >= len(items))
        dispatches.append(([(fid, rgb, depth) for _, fid, rgb, depth, _ in items], bucket))
        return out

    server._dispatch = recording
    published = []
    node = ros_node.HandNetRosNode(server, lambda topic, p: published.append((topic, p)))
    node.set_camera_info([600.0, 0, 320.0, 0, 600.0, 240.0, 0, 0, 1])
    rgb, mm = wire_frames(8, seed=740, hw=frame_hw)
    stamps = [100.0 + 0.5 * i for i in range(ROS_PAIRS)]
    reset_launch_counts()
    start = time.perf_counter()
    try:
        for i, t in enumerate(stamps):
            node.on_rgb(t, rgb[i % 8].astype(np.float32) / 255.0)
            if i % 2:
                node.on_depth(t + 0.03, mm[i % 8].astype(np.float32) / 1000.0, "32FC1")
            else:
                node.on_depth(t + 0.08, mm[i % 8], "16UC1")
        node.on_rgb(200.0, rgb[0].astype(np.float32) / 255.0)
        node.on_depth(200.5, mm[0], "16UC1")          # outside the slop: no pair
        got, deadline = 0, time.time() + 300
        while got < ROS_PAIRS and time.time() < deadline:
            got += node.drain(timeout=1.0)
        seconds = time.perf_counter() - start
        extra = node.drain(timeout=0.5)
    finally:
        server.stop()
    served = launch_counts()
    del server._dispatch
    ids = sorted(p["frame_id"] for _, p in published)
    if (got != ROS_PAIRS or extra or ids != list(range(ROS_PAIRS))
            or sorted(p["stamp"] for _, p in published) != stamps
            or {t for t, _ in published} != {"hand_pose"}
            or (dev.type == "cuda" and any(served.values()))):
        raise AssertionError(f"ros_node: published {got} (+{extra}) frames, ids {ids}, "
                             f"launches while serving {served}")
    by_id = {p["frame_id"]: p for _, p in published}
    paras = torch.from_numpy(node.paras[None])
    err_xyz = err = 0.0
    for fid, p in by_id.items():
        if not p["found"] or not np.isfinite(p["joints_uvd"]).all():
            raise AssertionError(f"ros_node: frame {fid} not found or non-finite")
        xyz = convert_joints(torch.from_numpy(p["joints_uvd"][None]),
                             torch.from_numpy(p["boxes"][None]), paras, 176, 176)[0]
        err_xyz = max(err_xyz, check(f"ros_node {fid} joints_xyz",
                                     torch.from_numpy(p["joints_xyz"]), xyz, 1e-3))
    for frames, bucket in dispatches:
        fids = [f for f, _, _ in frames]
        want = padded_eager(server._pipeline_forward, np.stack([r for _, r, _ in frames]),
                            np.stack([d for _, _, d in frames]), bucket, dev)
        for key in ("found", "boxes"):
            if not torch.equal(torch.from_numpy(np.stack([by_id[f][key] for f in fids])),
                               want[key]):
                raise AssertionError(f"ros_node: {key} of frames {fids} != the eager forward")
        err = max(err, check(f"ros_node frames {fids}", torch.from_numpy(
            np.stack([by_id[f]["joints_uvd"] for f in fids])), want["joints_uvd"], DEMO_TOL))
    log("demo_apps", f"HandNetRosNode over a started PipelineServer (fast, 480x640, bf16, "
        f"buckets {list(SERVE_BUCKETS)}): {ROS_PAIRS} pairs (16UC1 and 32FC1 in turns; one pair "
        f"outside the slop left unpaired) published once each with its stamp in "
        f"{seconds:.3f} s over {len(dispatches)} dispatches "
        f"{[len(f) for f, _ in dispatches]}; joints_xyz == convert_joints of the payload "
        f"(max |err| {err_xyz:.3e} mm); payloads == the eager forward of each dispatch's "
        f"padded wire batch (found, boxes exact; joints max |err| {err:.3e}, tol "
        f"{DEMO_TOL:g} px); capture launches {capture} in {calls} eager calls, none while "
        "serving (graph replays)")
    del server, node
    return per_call(capture, calls) if calls else capture


def a2j_infer_vis(dev, work: str, tree: str, a2j_ckpt: str, device_arg: str) -> None:
    """``a2j_infer.main --vis`` over 16 of the tree's depth PNGs: one
    ``_vis.jpg`` per frame; where cv2 imports, the port's drawing ==
    ``VisualUtil.plot``'s cv2 calls (``cv2.circle``, ``cv2.line``) pixel
    for pixel, and each file == ``cv2.imwrite``'s bytes."""
    import glob
    import os

    import numpy as np
    import torch

    from handnet_tpu_torch.apps import a2j_infer
    from handnet_tpu_torch.utils import vistool

    folder = os.path.join(work, "vis_pngs")
    os.makedirs(folder)
    pngs = sorted(glob.glob(os.path.join(tree, "**", "aligned_depth_to_color_*.png"),
                            recursive=True))[:A2J_VIS_FRAMES]
    for i, path in enumerate(pngs):
        os.symlink(path, os.path.join(folder, f"{i:04d}.png"))
    batch = 8
    reset_launch_counts()
    res = a2j_infer.main(["--input", folder, "--output", os.path.join(work, "vis"),
                          "--torch-checkpoint", a2j_ckpt, "--batch", str(batch), "--vis",
                          "--device", device_arg])
    device_sync(dev)
    launches = launch_counts()
    names = [os.path.basename(p) for p in res["vis"]]
    if (names != [f"{i:04d}_vis.jpg" for i in range(len(pngs))]
            or not all(os.path.exists(p) for p in res["vis"])
            or launches != {**{k: 0 for k in launches},
                            "a2j_decode": math.ceil(len(pngs) / batch)}):
        raise AssertionError(f"a2j_infer --vis: files {names}, launches {launches}")
    try:
        import cv2
    except ImportError:
        log("demo_apps", f"a2j_infer --vis: {len(names)} _vis.jpg files; cv2 is not installed, "
            "the drawing is not compared")
        return
    vt = vistool.VisualUtil("dexycb")
    frames = a2j_infer.read_frames(sorted(glob.glob(os.path.join(folder, "*.png"))), 176)
    for crop, uvd, path in zip(frames, res["uvd"], res["vis"]):
        vis = np.clip(crop[..., 0] * 255 / max(crop.max(), 1e-6), 0, 255).astype(np.uint8)
        vis = np.repeat(vis[:, :, None], 3, axis=-1)
        want = vis.copy()
        for i, color in enumerate(vistool.COLOR_PRED):   # VisualUtil._plot_fingers with cv2
            for idx in vt.jt_idx[i]:
                cv2.circle(want, (int(uvd[idx][0]), int(uvd[idx][1])), 2, color, -1)
            for s, e in vt.sketch[i]:
                cv2.line(want, (int(uvd[s][0]), int(uvd[s][1])),
                         (int(uvd[e][0]), int(uvd[e][1])), color, 1)
        if not np.array_equal(vt.plot(vis, None, None, uvd), want):
            raise AssertionError(f"a2j_infer --vis: {path}: the drawing differs from cv2's")
        ok, encoded = cv2.imencode(".jpg", want)
        with open(path, "rb") as f:
            if not ok or f.read() != encoded.tobytes():
                raise AssertionError(f"a2j_infer --vis: {path} != cv2.imwrite's bytes")
    log("demo_apps", f"a2j_infer.main --vis over {len(names)} depth PNGs (batch {batch}): one "
        f"_vis.jpg per frame; the skeletons == cv2 {cv2.__version__}'s circle/line pixel for "
        f"pixel and the files == cv2.imwrite's bytes; launches {launches}")


def statepack_round_trip(dev, work: str) -> None:
    """``utils/statepack.py``: the [train] and [train_a2j] trained models
    packed with their configs and read back; the trees and configs equal
    the saved ones, an A2J rebuilt from the file holds the saved state dict
    bit for bit, and its ``predict`` through K1 (one launch) equals the
    saved model's."""
    import os
    from types import SimpleNamespace

    import torch

    from handnet_tpu_torch.convert.from_flax import (a2j_state_dict_from_flax,
                                                     fcos_state_dict_from_flax)
    from handnet_tpu_torch.models.a2j import A2JSystem
    from handnet_tpu_torch.utils import statepack

    (fcos, fcfg), (a2j, acfg) = TRAINED["fcos"], TRAINED["a2j"]
    path = os.path.join(work, "states.msgpack")
    start = time.perf_counter()
    statepack.save_trained_states(path, SimpleNamespace(model=fcos), fcfg,
                                  SimpleNamespace(model=a2j), acfg, synth={"seed": SEED})
    f_vars, fcfg2, a_vars, acfg2, synth = statepack.load_trained_states(path)
    seconds = time.perf_counter() - start

    def same(got: dict, want: dict) -> bool:
        want = {k: v for k, v in want.items() if not k.endswith("num_batches_tracked")}
        return sorted(got) == sorted(want) and all(
            torch.equal(got[k].cpu().float(), want[k].cpu().float()) for k in want)

    rebuilt = A2JSystem(acfg2, norm="batch")
    rebuilt.load_state_dict(a2j_state_dict_from_flax(a_vars))
    if not ((fcfg2, acfg2, synth) == (fcfg, acfg, {"seed": SEED})
            and same(fcos_state_dict_from_flax(f_vars), fcos.state_dict())
            and same(rebuilt.state_dict(), a2j.state_dict())):
        raise AssertionError("statepack: the file does not give back the saved states")
    crops = a2j_train_batch(8, SEED + 1)["image"].to(dev)
    preds = []
    for model in (a2j, rebuilt):
        model.to(dev, memory_format=torch.channels_last).eval()
        reset_launch_counts()
        with torch.no_grad():
            preds.append(model.predict(crops))
        device_sync(dev)
        launches = launch_counts()
        if launches != {**{k: 0 for k in launches}, "a2j_decode": 1}:
            raise AssertionError(f"statepack: predict launched {launches}")
    if not (torch.equal(preds[0], preds[1]) and bool(torch.isfinite(preds[1]).all())):
        raise AssertionError("statepack: the loaded A2J predicts otherwise than the saved one")
    log("demo_apps", f"statepack: [train]'s FCOS and [train_a2j]'s A2J with their configs, "
        f"{os.path.getsize(path) / 2**20:.1f} MiB, written and read in {seconds:.3f} s; every "
        "parameter and statistic bit-equal; the loaded A2J's predict through K1 (1 launch) on "
        "8 crops == the saved model's, bit for bit")
    TRAINED.clear()


def phase_demo_apps(dev, cfg_fast, trees: str, device_arg: str = "cuda") -> dict:
    """The demo apps on the card through their entry points: ``demo.main``
    (the synthetic source at the default geometry; ``--flip-left
    --render-mesh``; the folder source over ``[fcos_apps]``' tree),
    ``a2j_mesh.main``, ``HandNetRosNode`` over a started server,
    ``a2j_infer --vis`` and a ``statepack`` round trip. Returns the launches
    per demo frame, per ``a2j_mesh`` sample and per eager call of the ROS
    node's server."""
    import os
    import tempfile

    from handnet_tpu_torch.apps import a2j_mesh, demo, ros_node

    paths = {}
    tree = os.path.join(trees, "tree")
    with tempfile.TemporaryDirectory() as work:
        ckpt = save_reference_checkpoints(demo, work)
        paths["demo"] = demo_runs(dev, demo, work, ckpt, device_arg)
        free_device_memory(dev)
        demo_folder(dev, demo, work, tree, ckpt, device_arg)
        free_device_memory(dev)
        paths["a2j_mesh"] = a2j_mesh_run(dev, a2j_mesh, work, ckpt[3], device_arg)
        free_device_memory(dev)
        paths["ros_node"] = ros_node_run(dev, ros_node, cfg_fast)
        free_device_memory(dev)
        a2j_infer_vis(dev, work, tree, ckpt[3], device_arg)
        statepack_round_trip(dev, work)
    free_device_memory(dev)
    return paths


def host_decoders() -> str:
    """What the host could decode images with: the versions of ``cv2``, PIL
    and ``yaml`` (or ``absent``), whether ``g++`` is on the PATH, and the
    ``libnvjpeg.so*`` files under ``/usr/local/cuda``. The port's data path
    uses none of the three modules; ``g++`` builds its PNG unfilter and RLE
    libraries."""
    import glob
    import importlib
    import shutil

    found = []
    for module, label in (("cv2", "cv2"), ("PIL", "PIL"), ("yaml", "yaml")):
        try:
            found.append(f"{label} {importlib.import_module(module).__version__}")
        except ImportError:
            found.append(f"{label} absent")
    try:
        import cv2

        jpeg = next((line.split(":", 1)[1].strip()
                     for line in cv2.getBuildInformation().splitlines()
                     if line.strip().startswith("JPEG:")), "not listed")
        found.append(f"cv2's JPEG: {jpeg}")
    except ImportError:
        found.append("cv2's JPEG: absent")
    gxx = shutil.which("g++")
    nvjpeg = sorted({p.rsplit("/", 1)[-1] for p in
                     glob.glob("/usr/local/cuda/**/libnvjpeg.so*", recursive=True)})
    return (", ".join(found) + f", g++ {'at ' + gxx if gxx else 'absent'}, libnvjpeg under "
            f"/usr/local/cuda: {', '.join(nvjpeg) if nvjpeg else 'absent'}")


def main() -> int:
    import torch

    started = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    # the mesh head's graph pyramid is built on the host with scipy
    # (handnet_tpu_torch/ops/graph.py): without it the [mesh] phase cannot run
    import scipy

    log("card", f"torch {torch.__version__}, CUDA {torch.version.cuda}, scipy "
        f"{scipy.__version__}, {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    log("card", f"host decoders: {host_decoders()}")
    dev = torch.device("cuda", 0)

    from handnet_tpu_torch.config import FAST, QUANT, QUANT_STATIC, load_config, resolve_config
    from handnet_tpu_torch.kernels import build

    res = build.build_library()
    build.load_library()
    log("build", f"{res.path.name} in {res.seconds:.2f} s (0 = already built)")
    for line in res.log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            log("build", line.strip())
    lap_start = [started]

    def lap(phase: str) -> None:   # each phase's seconds: the time budget
        now = time.perf_counter()
        log(phase, f"the phase took {now - lap_start[0]:.1f} s")
        lap_start[0] = now

    lap("build")

    def found_path(cfg):  # score threshold 0: every frame takes the found path
        return dataclasses.replace(cfg, fcos=dataclasses.replace(cfg.fcos, score_thresh=0.0))

    def with_mesh(cfg):   # the fused mesh head, at its full widths
        return dataclasses.replace(cfg, pipeline=dataclasses.replace(cfg.pipeline,
                                                                     with_mesh=True))

    cfg, cfg_quant, cfg_dynamic = (found_path(load_config(overrides=o))
                                   for o in (FAST, QUANT_STATIC, QUANT))
    geometry_cfgs = {
        "fast": cfg, "parity": found_path(resolve_config("parity")),
        "parity_int8": found_path(resolve_config("parity", quant="static")),
        "turbo": found_path(resolve_config("turbo")),
        "ext": found_path(load_config(overrides={**FAST, "fcos": {**FAST["fcos"], "ext": True}})),
    }

    # the serving tier first: its graphs, server and artifact (launches per
    # eager call of each serving path)
    by_path = phase_serve(dev, cfg, cfg_quant)
    log("serve", f"device memory after the phase: {torch.cuda.memory_allocated() / 2**30:.2f} "
        f"GiB allocated, {torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")
    lap("serve")
    results = {"a2j_decode": phase_a2j_kernel(dev), **phase_gn_kernels(dev)}
    geos = int8_geometries(dev, cfg_dynamic)
    if (sum(map(len, geos.values())) != INT8_LAUNCHES_PER_CALL
            or len({n for names in geos.values() for n in names}) != INT8_LAYERS):
        raise AssertionError(f"int8 path: {len(geos)} geometries, unexpected layer counts")
    phase_quantize_kernel(dev)
    k3 = phase_int8_kernel(dev, geos)
    results["int8_quantize"], results["int8_conv_gemm"] = k3["k3q"], k3["k3g"]
    phase_encode_host_time(dev, geos)
    lap("kernels")

    by_path["fast"] = phase_slice(dev, cfg)
    # the main path of this script: every kernel runs in the quant_static slice
    launches = phase_quant_slice(dev, cfg_quant, cfg_dynamic)
    by_path["quant_static"] = per_call(launches, len(SLICE_REQUESTS))
    lap("slice")
    geometries = phase_geometries(dev, geometry_cfgs)
    by_path.update(geometries["paths"])
    for name, shapes in geometries["kernel_shapes"].items():
        results[name]["shapes"] = shapes
    lap("geometries")
    phase_throughput(dev, cfg, cfg_quant)
    phase_geometry_throughput(dev, geometry_cfgs)
    free_device_memory(dev)
    lap("throughput")
    by_path.update(phase_mesh(dev, *(with_mesh(c) for c in (cfg, cfg_quant))))
    free_device_memory(dev)
    lap("mesh")
    # apps/train_fcos.py's 100DOH run: FCOSConfig's defaults with 3 classes
    by_path["train_fcos"] = phase_train(dev, load_config().fcos)
    log("train", f"device memory after the phase: {torch.cuda.memory_allocated() / 2**30:.2f} "
        f"GiB allocated")
    lap("train")
    # apps/train_a2j.py's recipe, then the Pose2Mesh app at its defaults
    by_path.update(phase_train_a2j(dev))
    lap("train_a2j")
    by_path["train_mesh"] = phase_train_mesh(dev)
    lap("train_mesh")
    # the A2J apps through their entry points
    by_path.update(phase_a2j_apps(dev))
    lap("a2j_apps")
    # the FCOS apps and train_a2j --rgbd through their entry points, then
    # the Faster R-CNN's on the same trees
    import tempfile

    with tempfile.TemporaryDirectory() as trees:
        fcos_apps = phase_fcos_apps(dev, trees)
        by_path.update(fcos_apps["paths"])
        for name, shapes in fcos_apps["shapes"].items():
            results[name]["backbone_shapes"] = shapes
        lap("fcos_apps")
        by_path.update(phase_rcnn(dev, trees, smi)["paths"])
        lap("rcnn")
        # the demo apps: demo, a2j_mesh, the ROS node, a2j_infer --vis, statepack
        by_path.update(phase_demo_apps(dev, cfg, trees))
        lap("demo_apps")
    phase_idle_shares(dev, cfg)
    lap("throughput")

    sources = {"a2j_decode": ("handnet_tpu_torch/csrc/a2j_decode.cu",
                              "handnet_tpu/ops/pallas_a2j.py:55"),
               "gn_group_stats": ("handnet_tpu_torch/csrc/gn_stats.cu",
                                  "handnet_tpu/ops/pallas_gn.py:138"),
               "gn_apply": ("handnet_tpu_torch/csrc/gn_apply.cu",
                            "handnet_tpu/ops/pallas_gn.py:167"),
               "int8_quantize": ("handnet_tpu_torch/csrc/int8_quantize.cu",
                                 "handnet_tpu/nn/quant.py:135"),
               "int8_conv_gemm": ("handnet_tpu_torch/csrc/int8_conv.cu",
                                  "handnet_tpu/nn/quant.py:139")}
    # launches: the quant_static run's (4 calls); launches_per_call: each
    # path's, counted from 0 just before it and read just after
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": replaces,
                "launches": launches[name], **results[name],
                "launches_per_call": {path: counts[name] for path, counts in by_path.items()}}
               for name, (src, replaces) in sources.items()]
    log("card", f"device_ms: {PROFILER_SESSIONS['short']} of "
        f"{PROFILER_SESSIONS['sessions']} profiler sessions lost kernel records "
        f"({PROFILER_SESSIONS['lost_records']} in all) and were taken again or priced by "
        "their recorded launches")
    log("card", f"every phase passed in {time.perf_counter() - started:.1f} s, the kernels' "
        "build included")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
