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
   First the GroupNorm backward's kernels against their plain versions at
   the P3 train shape [8, 100, 136, 256] and the GroupNorm backbone's five
   shapes, x and parameters in float32 and bf16, ReLU on and off: K2r's
   sums and dparams to 1e-5 of scale, K2d bit for bit on K2r's sums, two
   launches of each bit-equal. GroupNorm + ReLU at the P3 train shape,
   float32 and bf16: K2s + K2a + K2r + K2d against autograd through the
   plain versions (dx, dscale, dbias); forward + backward, the backward
   alone, K2r and K2d timed beside their bounds, ``F.group_norm`` +
   autograd and the gradients registered on the forward ops; the matcher at
   800x1088 with a float32 area tie, card == CPU; one step of two trainers
   from one seed with the kernels and with their plain versions, bf16 and
   float32 (TF32 off): every loss term and every parameter's gradient; 20
   steps on the repeated batch (K2s, K2a, K2r and K2d 24 launches per step,
   K1 and K3 none; every loss finite, the last total below half the first,
   master weights float32), ms per step by the loop clock after 3 steps,
   images/s, peak memory, and a profile of one step by kernel (top 10, the
   shares of K2s/K2a and of K2r/K2d, the gradients copied to NHWC); one
   step with a frozen backbone (running statistics unchanged, its affine
   moved).

ddp (after train): data parallelism on the one card. ``train_fcos`` at
   800x1088, batch 8, bf16, 3 steps on a synthetic tree (8 sequences):
   without torchrun (after a warm-up run), as one NCCL rank (torchrun's environment in this
   process, its launches counted) and under ``python -m
   torch.distributed.run --nproc-per-node 1 -m
   handnet_tpu_torch.apps.train_fcos``; metrics.json and the checkpoint
   must equal the first run's bit for bit (K2s/K2a/K2r/K2d 24 per step; ms
   per step with and without DDP). Two gloo ranks sharing the card (NCCL
   refuses two ranks on one device), CUDA tensors: one float32 step (TF32
   off) of ``FCOSTrainer`` at the [train] width (4 frames a rank) and of
   ``A2JTrainer`` at the recipe (32 crops a rank), against the one-process
   whole-batch steps (losses to 1e-4; gradients, running statistics and
   FCOS's SGD update in relative L2 to 1e-2, A2J's to 5e-2, the tolerance
   of tests/test_parallel.py for JAX's own mesh step), the ranks' losses and
   parameters equal, K2s/K2a/K2r/K2d 24 per FCOS step, none per A2J step,
   A2J's eval step on each rank's inner module (K1 once).
   ``PipelineServer(mesh=create_mesh(1))`` at fast, buckets 8/128, bf16:
   264 frames queued before start == the one-device server's bit for bit
   (dispatches 128, 128, 8), K1 1 and K2s/K2a 24 per capture call, both
   ``sustained_fps`` beside the card's name and power limit.

train_a2j (after ddp): ``A2JTrainer`` at apps/train_a2j.py's recipe
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
   threads): ms per step, images/s, the loader-wait share, K2s/K2a/K2r/K2d
   24 per step and nothing else, finite losses; a train step alone and beside 8
   busy loader threads; ``train_fcos.main --voc-root --backbone-norm
   group`` (1 epoch): K2s/K2a/K2r/K2d 60 per step, the trained backbone's
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

a2j_2d (after train_a2j): the 2D A2J (``is_3d=False``) at full width
   (ResNet-50-dilated, 176^2 crops, 21 joints, no depth head). K1xy, K1's
   depth-free variant, against its plain version at B = 1, 8 and 128 in
   float32 and bf16 (1e-4 of the coordinate scale, two runs bit-equal), an
   unaligned shape, strided views refused, its times with its byte bound
   (cls and reg read, the [B, P, 2] output written); the SHA-256 of the 3D
   K1's output at B=128, N=1936, P=21, bf16 on seeded heads (``python3
   k12_device_times.py --k1-hash [--root DIR]`` prints another checkout's,
   to show that K1 keeps its bits); ``A2JSystem.predict`` at B=128 bf16 (3
   calls, K1xy once per call and K1 never); in float32 (TF32 off) the K1xy
   path against the plain path and the CPU run; 3 ``A2JTrainer`` steps at
   batch 64 bf16 (finite, moving losses, no launch of ours) and the eval
   step (``[B, P, 2]`` targets through K1xy once; ``[B, P, 3]`` targets
   refused with ``ValueError``, as JAX's eval step fails to broadcast them).

a2j_group (after a2j_2d): A2J with GroupNorm(32) in all 65 norms
   (``A2JSystem(norm="group")``) at full width. K2s and K2a at its wide
   shapes, 11x11 with C = 1024 and 2048 (C/G 32 and 64; a float32 row of
   2048 channels is one 512-thread block), B = 1, 8, 64 and 128, float32
   and bf16: K2s to 1e-4 of scale, K2a bit-equal to its plain version, two
   runs of each bit-equal, the mean >> std case; at B=128 both timed beside
   their byte bounds, their plain versions, ``torch.var_mean`` and
   ``F.group_norm``. K2r and K2d at the same wide shapes, B = 1, 8 and 64,
   float32 and bf16, parameters in float32 and in x's type, ReLU on and
   off, and the mean >> std case: K2r to 1e-5 of scale, K2d bit-equal to
   its plain version on K2r's sums, two runs of each bit-equal; at B=64 both
   timed at 11x11 with C = 256, 1024 and 2048 beside their byte bounds,
   their plain versions and ``native_group_norm_backward``. Then the train
   step (``A2JTrainer.train_step`` on a ``TrainState`` of the GroupNorm
   A2J, batch 64, AdamW) in float32 (TF32 off) and bf16: 65 launches each
   of K2s, K2a, K2r and K2d per step and none through the plain versions
   (``use_kernels=False``), whose gradients the kernels' must match (loss
   and per-tensor tolerances in ``A2J_GROUP_STEP_TOL``); three AdamW
   updates with finite losses; ms per step by CUDA events and, in bf16,
   the step's kernels on the device beside the batch-norm A2J's. Then
   ``predict`` at B = 64 and 128 in float32 and bf16
   (autocast), seeded random convs and norm affines: 65 K2s + 65 K2a + 1 K1
   per call and nothing else, two calls bit-equal, the kernel path against
   the plain path (``use_kernels=False``) within 1e-2 px in float32 (TF32
   off) and 1 px in bf16, and crops/s against the frozen-BN A2J at the same
   batch and dtype. The phase prints its own lap.

e2e_eval (after demo_apps, on fcos_apps' tree): ``E2EDataSource`` items
   (16 of 480x640, colour and depth decoded by the port, the mesh from a
   synthetic ``ManoLayer`` on the card: the MANO pickle is not in the
   repository); the fast pipeline on them in bf16 batches of 8 (K2s and K2a
   24 and K1 1 per call); ``CocoDetEvaluator`` bbox and keypoints of its
   hands (the GT boxes and joints given back score AP 1.0; the seed-2
   weights' hands a finite AP in [0, 1]); ``SequenceLoader`` over a tree
   of 8 cameras x 480x640 16-bit PNGs with its ``meta.yml`` and
   ``extrinsics.yml``, ``deproject_depth`` on the card against float64
   numpy (1e-5 m), its device time and the host's PNG read per frame; the
   offset field card against CPU; ``BOPEvaluator`` with VSD at 480x640 and
   ``GraspEvaluator`` over 2 scenes of 100 candidate grasps at the 8
   distance thresholds, each timed on the host.

learn (after e2e_eval): the learning gates through their ``main(argv)``
   with ``--device cuda``, each on a synthetic tree of its own (24
   sequences x 6 frames, 24 held out): ``synthetic_e2e_validation --batch
   8 --fcos-steps 300 --a2j-steps 1200`` (the tools' 256x352 detector
   input, 96^2 crops, static int8) in this process, and
   ``rcnn_convergence --with-fcos --steps 300 --image-h 192 --image-w 256``
   in a spawned one beside it. Each must PASS; each path's calls and
   launches per call must be the expected ones (K2s/K2a/K2r/K2d 24 per FCOS
   step, none per A2J or R-CNN step, K1 1 per eval step and pipeline call,
   K3q/K3g 129 per int8 call and 194 for the calibration batch, K2s/K2a 24
   per FCOS detect), and every launch of a run must fall in a counted
   call. It prints each stage's loss, seconds, steps/s and loader-wait
   share, the held-out found rate, IoU, MPJPE (float and int8), the R-CNN's
   and the FCOS control's AP/AP50/AP75, and whether the margins held
   (found >= 90%, IoU >= 0.6, MPJPE <= 45 mm, AP50 >= 0.6); then, on the
   trained stages, K3 bit for bit against its plain version in the
   calibrated pipeline, K1 against its plain decode on the trained heads
   (N = 576) and the float32 pipeline assembled from the trained states
   against the trainers' eval forwards (TF32 off, 1e-2 px). The e2e run
   writes its trained stages to ``build/studies/learn_states.msgpack``
   (``--save-state``) for studies.

studies (after learn): the two study tools through their ``main(argv)``
   with ``--device cuda``. ``resolution_study --resolutions 512x640
   800x1088 480x640@qs --steps 150 --batch 8`` trains the full-width
   detector (ResNet-34 + FPN-256, GroupNorm(32) towers) at fast's, parity's
   and quant_static's detector inputs and evaluates each on the 24 held-out
   frames (the last through static int8, calibrated on 16 training frames
   with no margin); it is host-bound as learn's stages are, so it starts in
   a spawned process when learn starts and runs beside it, and this phase
   joins it. ``int8_saturation_study --state <learn's pack>`` runs the
   float and static-int8 pipelines (256x352, 96^2 crops) on the held-out
   frames at gains 1.0, 1.3, 1.6 and 2.0 (not clipped) and margins 0, 0.1
   and 0.25. Each path's calls and launches per call must be the expected
   ones (``study_*``: K2s/K2a/K2r/K2d 24 per FCOS train step, K2s/K2a 24
   per float detect, and K3q/K3g 65 more per int8 detect and per detector
   calibration, the pipeline's 24 + K1 1 (+ K3q/K3g 129 in int8) per call
   and 48 + 194 per calibration), and every launch must fall in a counted
   call. On 8 held-out frames at gain 2.0, the margin-0 static-int8
   pipeline and the trained ``@qs`` detector must give every output bit
   for bit with K3's plain version in place of K3. It prints each spec's
   record, steps/s and loader-wait share, the saturation rows, the paired
   margins and the table, which gate nothing.

The ``[card]`` line also gives scipy's version: the mesh head's graph
pyramid is built with it, and the script fails without it; and the host's
decoders (cv2 and the JPEG library it bundles, PIL, yaml, g++, libnvjpeg),
which the port does not use.

In the ``{"kernels": [...]}`` line ``ms``, ``plain_ms`` and ``library_ms``
are times on the device; ``loop_ms`` is the wrapper loop's; ``launches`` is
the quant_static run's (K1xy's: the 2D predict run's; K2r's and K2d's: the
20-step learning run's of train; each its main path),
``launches_per_call`` each path's (for the serving
paths, per eager warm-up or capture call: a replay launches through no
wrapper; ``train_fcos``, ``train_a2j`` and ``train_mesh`` per train step,
``eval_a2j`` per eval step, ``ddp_train_fcos_nccl`` per step of the
one-rank CLI, ``ddp_gloo_fcos`` and ``ddp_gloo_a2j`` per rank and step,
``ddp_gloo_eval_a2j`` per rank's eval step, ``ddp_serve_mesh`` per warm-up
or capture call of the mesh server, ``a2j_apps_eval`` per batch of the CLI's eval
sweeps, ``a2j_infer`` per batch of the app, ``train_fcos_app`` and
``train_fcos_voc_group`` per step of the CLI, ``eval_fcos`` per detect
call, ``train_a2j_rgbd_eval`` per eval batch, ``demo`` per frame,
``a2j_mesh`` per sample, ``ros_node`` per eager call of its server's
capture, ``a2j_2d_predict`` per 2D predict call, ``train_a2j_2d`` per 2D
train step, ``eval_a2j_2d`` for one 2D eval step, ``a2j_group`` per
GroupNorm A2J predict call, ``train_a2j_group`` per GroupNorm A2J train
step, ``e2e_pipeline`` per call
on the E2E items; the gates': ``learn_train_fcos``, ``learn_train_a2j``,
``learn_train_rcnn`` and ``learn_train_fcos_control`` per train step,
``learn_eval_a2j`` per eval step, ``learn_pipeline`` and
``learn_pipeline_int8`` per held-out pipeline call, ``learn_calibrate``
per calibration batch, ``learn_detect_rcnn`` and ``learn_detect_fcos`` per
held-out detect call; the studies': ``study_train_fcos`` per train step,
``study_detect`` and ``study_detect_int8`` per held-out detect call,
``study_calibrate_detector`` per detector calibration,
``study_pipeline`` and ``study_pipeline_int8`` per pipeline call and
``study_calibrate`` per pipeline calibration), K2s's and K2a's ``shapes``
hold their numbers at the shapes of phase 5, ``backbone_shapes`` at
the GroupNorm backbone's, and ``a2j_group_shapes`` at A2J-GN's wide ones
(B=128, float32 and bf16; K2r's and K2d's at B=64, 11x11 with C = 256, 1024
and 2048). K2r's and K2d's numbers are at the P3 train
shape with the train route's pair beside them (``pair_train_*``,
``backward_*``) and the profiled step's (``step_profile``); their
``library_ms`` is ``aten.native_group_norm_backward`` for the same outputs
(dscale and dbias; dx), which computes its own sums and has no ReLU.

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
# the GroupNorm kernels of a train step, each once per layer: K2s and K2a
# forward, K2r and K2d backward
GN_TRAIN_KERNELS = ("gn_group_stats", "gn_apply", "gn_backward_sums", "gn_backward_dx")
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
# K2s + K2a + K2r + K2d against autograd through the plain versions at
# GN_TRAIN_SHAPE, and K2r + K2d's dx against the plain pair's, as a share of
# each gradient's largest |value| (values set with the registered gradient):
# float32 differs by the statistics' summation order; bf16 rounds dx to
# bf16 (an ulp is 2^-8 of a value) in two terms, each path after its own
# float32 arithmetic (measured: dx 1.9e-7 f32, 1.5e-3 bf16; dscale 3.5e-7)
GN_GRAD_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# the train step with kernels against the plain versions (same seed, same
# batch): each loss term (relative) and each parameter's gradient (norm of
# the difference over the norm), bf16 and float32 with TF32 off. The two
# differ by the statistics' last bits in the forward and by the gradient's
# formula (K2r + K2d against autograd's through the plain ops; the values
# were measured with the gradient registered on the ops), and cuDNN's
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
        return a2j_heads(gen, dev, b, dtype, n, p)

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


def expected_launches(calls: int, gn: int, int8: int = 0, gn_backward: int = 0) -> dict:
    return {"gn_group_stats": gn * calls, "gn_apply": gn * calls,
            "gn_backward_sums": gn_backward * calls, "gn_backward_dx": gn_backward * calls,
            "a2j_decode": calls, "a2j_decode_xy": 0, "int8_quantize": int8 * calls,
            "int8_conv_gemm": int8 * calls}


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
    from handnet_tpu_torch.ops.cuda_a2j import a2j_decode, a2j_decode_xy
    from handnet_tpu_torch.ops.cuda_gn import (gn_apply, gn_backward_dx, gn_backward_sums,
                                               gn_group_stats)
    from handnet_tpu_torch.ops.cuda_int8_conv import int8_conv_gemm, int8_quantize

    return {"a2j_decode": a2j_decode, "a2j_decode_xy": a2j_decode_xy,
            "gn_group_stats": gn_group_stats, "gn_apply": gn_apply,
            "gn_backward_sums": gn_backward_sums, "gn_backward_dx": gn_backward_dx,
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


def k3_bit_equal(name: str, model, run) -> dict:
    """``run()`` with K3 and with K3's plain version in every ``QuantConv``
    of ``model``: every output must be equal bit for bit. Returns K3's."""
    import torch

    got = run()
    set_int8_kernel(model, False)
    try:
        want = run()
    finally:
        set_int8_kernel(model, True)
    for key, value in got.items():
        if not torch.equal(value, want[key]):
            raise AssertionError(f"{name}: {key} differs between K3 and its plain version")
    return got


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
    expected = expected_launches(calls, GN_LAYERS_PER_CALL, INT8_LAUNCHES_PER_CALL)
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
counted = {"a2j_decode": cuda_a2j.a2j_decode, "a2j_decode_xy": cuda_a2j.a2j_decode_xy,
           "gn_group_stats": cuda_gn.gn_group_stats, "gn_apply": cuda_gn.gn_apply,
           "gn_backward_sums": cuda_gn.gn_backward_sums,
           "gn_backward_dx": cuda_gn.gn_backward_dx,
           "int8_quantize": cuda_int8_conv.int8_quantize,
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
    """GroupNorm + ReLU at the P3 train shape, float32 and bf16: the train
    route (K2s, K2a, K2r and K2d, one launch each) against autograd through
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
        if {k: counts[k] for k in GN_TRAIN_KERNELS} != dict.fromkeys(GN_TRAIN_KERNELS, 1):
            raise AssertionError(f"GroupNorm forward + backward launched {counts}: expected "
                                 "K2s, K2a, K2r and K2d once each")
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
        log("train", f"GN gradient {list(GN_TRAIN_SHAPE)} G=32 ReLU {dtype}: K2s + K2a + K2r + "
            "K2d vs autograd through the plain versions: "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
            + f" of scale (tol {tol:g}); {flips} ReLU masks differ (left out of dx)")
        del got, want, agree


def output_hash(*tensors) -> str:
    """SHA-256 of the tensors' bytes, in order."""
    import hashlib

    import torch

    digest = hashlib.sha256()
    for t in tensors:
        digest.update(t.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return digest.hexdigest()


def native_group_norm_backward(x, dy, scale, bias, g: int, mask, eps: float = 1e-5):
    """``fn()`` calling ``aten.native_group_norm_backward`` (the library's
    GroupNorm backward, which the port never calls) for the outputs that
    ``mask`` selects (dx, dscale, dbias), on NCHW copies of NHWC ``x`` and
    ``dy`` with its own statistics, the parameters in x's type, no ReLU."""
    import torch

    b, h, w, c = x.shape
    x_nchw, dy_nchw = (t.permute(0, 3, 1, 2).contiguous() for t in (x, dy))
    w_x, b_x = scale.detach().to(x.dtype), bias.detach().to(x.dtype)
    _, mean, rstd = torch.ops.aten.native_group_norm(x_nchw, w_x, b_x, b, c, h * w, g, eps)
    return lambda: torch.ops.aten.native_group_norm_backward(dy_nchw, x_nchw, mean, rstd, w_x, b,
                                                             c, h * w, g, mask)


def gn_backward_times(x, dy, stats, scale, bias, g: int, eps: float = 1e-5) -> dict:
    """K2r and K2d alone at x's shape, ReLU on: device and loop ms, the
    bound (x and dy read; K2d also writes dx), the plain versions' device ms
    and the library's ms for the same outputs (``library_ms``:
    ``native_group_norm_backward`` for dscale and dbias, for dx). Returns
    the two kernels' JSON numbers."""
    from handnet_tpu_torch.ops.cuda_gn import (gn_backward_dx, gn_backward_dx_reference,
                                               gn_backward_sums, gn_backward_sums_reference)

    sums, _ = gn_backward_sums(x, dy, stats, scale, bias, eps, True)
    small = nbytes(stats, scale, bias)
    # per element: K2r a subtraction, the mask's multiply, add and compare,
    # two accumulations; K2d those of the mask, three multiplies and two
    # subtractions (float32, outside the tensor cores)
    return {
        "gn_backward_sums": {
            **timed(lambda: gn_backward_sums(x, dy, stats, scale, bias, eps, True)),
            **bound(2 * nbytes(x) + small, 6 * x.numel(), F32_FLOPS_PER_S),
            "plain_ms": device_ms(lambda: gn_backward_sums_reference(x, dy, stats, scale, bias,
                                                                     eps, True)),
            "library_ms": device_ms(native_group_norm_backward(x, dy, scale, bias, g,
                                                               [False, True, True], eps))},
        "gn_backward_dx": {
            **timed(lambda: gn_backward_dx(x, dy, stats, scale, bias, sums, eps, True)),
            **bound(3 * nbytes(x) + small + nbytes(sums), 9 * x.numel(), F32_FLOPS_PER_S),
            "plain_ms": device_ms(lambda: gn_backward_dx_reference(x, dy, stats, scale, bias,
                                                                   sums, eps, True)),
            "library_ms": device_ms(native_group_norm_backward(x, dy, scale, bias, g,
                                                               [True, False, False], eps))}}


def gn_backward_kernel_checks(dev) -> dict:
    """K2r and K2d against their plain versions on the card, at the P3 train
    shape and the GroupNorm backbone's five shapes (B=8, G=32), x in float32
    and bfloat16, parameters in float32 and bfloat16, ReLU on and off:
    K2r's sums and dparams to 1e-5 of their scale (the same values summed in
    another order); K2d bit for bit against its plain version on K2r's sums;
    dx of K2r + K2d against the plain pair to ``GN_GRAD_TOL``; two launches
    of each give the same bits (hashes of both runs' outputs). At the
    backbone's shapes, bf16 with float32 parameters, both are timed
    (:func:`gn_backward_times`). Returns K2r's largest absolute error
    (``err``) and the per-kernel times by backbone shape (``backbone``)."""
    import torch

    from handnet_tpu_torch.ops.cuda_gn import (gn_backward_dx, gn_backward_dx_reference,
                                               gn_backward_sums, gn_backward_sums_reference,
                                               gn_group_stats)

    gen = torch.Generator(device=dev).manual_seed(SEED)
    eps, b = 1e-5, TRAIN_BATCH
    shapes = [GN_TRAIN_SHAPE[1:] + (32,)] + list(BACKBONE_GN_SHAPES)
    worst = {"sums": 0.0, "dparams": 0.0, "dx": 0.0}
    worst_abs, cases = 0.0, 0
    backbone = {"gn_backward_sums": [], "gn_backward_dx": []}
    for h, w, c, g in shapes:
        x = torch.randn(b, h, w, c, device=dev, generator=gen) * 3 + 2
        dy = torch.randn(b, h, w, c, device=dev, generator=gen)
        scale = torch.rand(c, device=dev, generator=gen) + 0.5
        bias = torch.randn(c, device=dev, generator=gen)
        for dtype in (torch.float32, torch.bfloat16):
            xd, dyd = x.to(dtype), dy.to(dtype)
            stats = gn_group_stats(xd, g)
            tol = GN_GRAD_TOL[str(dtype).split(".")[-1]]
            for params in (torch.float32, torch.bfloat16):
                sc, bi = scale.to(params), bias.to(params)
                for relu in (False, True):
                    name = f"B={b} {h}x{w}x{c} G={g} x {dtype} params {params} relu={relu}"
                    runs = [gn_backward_sums(xd, dyd, stats, sc, bi, eps, relu) for _ in range(2)]
                    hashes = [output_hash(*run) for run in runs]
                    if hashes[0] != hashes[1]:
                        raise AssertionError(f"K2r {name}: two runs differ ({hashes})")
                    sums, dparams = runs[0]
                    want = gn_backward_sums_reference(xd, dyd, stats, sc, bi, eps, relu)
                    for key, got, ref in zip(("sums", "dparams"), (sums, dparams), want):
                        scale_of = ref.abs().max().item()
                        worst_abs = max(worst_abs, check(f"K2r {key} {name}", got, ref,
                                                         1e-5 * scale_of))
                        worst[key] = max(worst[key], ((got - ref).abs().max() / scale_of).item())
                    dx = [gn_backward_dx(xd, dyd, stats, sc, bi, sums, eps, relu)
                          for _ in range(2)]
                    if output_hash(dx[0]) != output_hash(dx[1]):
                        raise AssertionError(f"K2d {name}: two runs differ")
                    same_sums = gn_backward_dx_reference(xd, dyd, stats, sc, bi, sums, eps, relu)
                    if dx[0].dtype != dtype or not torch.equal(dx[0], same_sums):
                        diff = (dx[0].double() - same_sums.double()).abs()
                        raise AssertionError(
                            f"K2d {name}: not bit-equal to its plain version on K2r's sums "
                            f"({int((diff > 0).sum())} elements differ, max "
                            f"{diff.max().item():.3e})")
                    plain = gn_backward_dx_reference(xd, dyd, stats, sc, bi, want[0], eps, relu)
                    err = ((dx[0].float() - plain.float()).abs().max()
                           / plain.float().abs().max()).item()
                    if not err <= tol:
                        raise AssertionError(f"K2r + K2d {name}: dx max|err| {err:.3e} of its "
                                             f"scale > {tol:g}")
                    worst["dx"] = max(worst["dx"], err)
                    cases += 1
                    del runs, sums, dparams, want, dx, same_sums, plain
            line = (f"K2r/K2d B={b} {h}x{w}x{c} G={g} {dtype} (params f32 and bf16, ReLU on and "
                    f"off): K2r hash {hashes[0][:16]} twice; K2d bit-equal to its plain version "
                    "on K2r's sums")
            if dtype == torch.bfloat16 and (h, w, c, g) in BACKBONE_GN_SHAPES:
                times = gn_backward_times(xd, dyd, stats, scale, bias, g, eps)
                shape = f"B={b} {h}x{w}x{c} G={g} bf16, f32 params, ReLU"
                for name, t in times.items():
                    backbone[name].append({"shape": shape,
                                           "layers": BACKBONE_GN_SHAPES[(h, w, c, g)], **t})
                line += "; " + "; ".join(
                    f"{'K2r' if name == 'gn_backward_sums' else 'K2d'} {t['ms']:.4f} ms on the "
                    f"device (loop {t['loop_ms']:.4f}), bound {t['bound_ms']:.4f} "
                    f"({100 * t['bound_ms'] / t['ms']:.0f}%), plain {t['plain_ms']:.4f}, "
                    f"native_group_norm_backward {t['library_ms']:.4f}"
                    for name, t in times.items())
            log("train", line)
            del xd, dyd, stats
        del x, dy
    log("train", f"K2r and K2d at the train shape and the {len(BACKBONE_GN_SHAPES)} backbone "
        f"shapes, {cases} cases: K2r sums max|err| {worst['sums']:.3e}, dparams "
        f"{worst['dparams']:.3e} of scale (tol 1e-5); two launches give the same bits; K2d "
        f"bit-equal to its plain version on the same sums; dx against the plain pair "
        f"{worst['dx']:.3e} of scale (tol {GN_GRAD_TOL['float32']:g} f32, "
        f"{GN_GRAD_TOL['bfloat16']:g} bf16)")
    return {"err": worst_abs, "backbone": backbone}


def gn_train_yardstick(dev, k2r_err: float) -> dict:
    """GroupNorm + ReLU at the P3 train shape in bf16 with float32
    parameters (as the trainer holds them), on the device and by loop:
    forward + backward, the backward alone, K2r alone and K2d alone, each
    beside its byte bound; the route's pair beside ``F.group_norm`` +
    ``F.relu`` with autograd's own backward (which the port never calls)
    and beside K2s + K2a with the gradients registered on the ops (the
    route before K2r and K2d). K2r's yardstick call is
    ``aten.native_group_norm_backward`` for dscale and dbias, K2d's the
    same call for dx alone (each computes its own sums, without the ReLU
    mask), on NCHW copies (:func:`gn_backward_times`). Returns the JSON
    numbers of K2r and K2d."""
    import torch
    import torch.nn.functional as F

    from handnet_tpu_torch.ops.cuda_gn import gn_apply, gn_group_stats, group_norm

    gen = torch.Generator(device=dev).manual_seed(SEED)
    b, h, w, c = GN_TRAIN_SHAPE
    g, eps = 32, 1e-5
    x = (torch.randn(b, h, w, c, device=dev, generator=gen) * 3 + 2).to(torch.bfloat16)
    dy = torch.randn(b, h, w, c, device=dev, generator=gen).to(torch.bfloat16)
    sc = (torch.rand(c, device=dev, generator=gen) + 0.5).requires_grad_()
    bi = torch.randn(c, device=dev, generator=gen).requires_grad_()
    # F.group_norm on the card takes its parameters only in x's type
    sc16, bi16 = (t.detach().to(torch.bfloat16).requires_grad_() for t in (sc, bi))
    xk = x.clone().requires_grad_()
    xc = x.permute(0, 3, 1, 2).detach().requires_grad_()   # NCHW view, channels_last bytes
    dyc = dy.permute(0, 3, 1, 2)
    inputs = {"route": (xk, sc, bi), "registered": (xk, sc, bi), "library": (xc, sc16, bi16)}
    forwards = {
        "route": lambda: group_norm(xk, sc, bi, g, eps, relu=True),
        "registered": lambda: gn_apply(xk, gn_group_stats(xk, g), sc, bi, eps, True),
        "library": lambda: F.relu(F.group_norm(xc, g, sc16, bi16, eps)),
    }
    grads = {"route": dy, "registered": dy, "library": dyc}
    pair = {k: timed(lambda k=k, fwd=fwd: torch.autograd.grad(fwd(), inputs[k], grads[k]))
            for k, fwd in forwards.items()}
    backward = {}
    for k, fwd in forwards.items():
        y = fwd()
        backward[k] = timed(lambda k=k, y=y: torch.autograd.grad(y, inputs[k], grads[k],
                                                                 retain_graph=True))
        del y
    stats = gn_group_stats(x, g)
    alone = gn_backward_times(x, dy, stats, sc.detach(), bi.detach(), g, eps)
    k2r, k2d = alone["gn_backward_sums"], alone["gn_backward_dx"]
    lib_pair = timed(native_group_norm_backward(x, dy, sc, bi, g, [True, True, True], eps))
    tensor = nbytes(x)
    bounds = {"fwd+bwd": bound(4 * tensor, 0, F32_FLOPS_PER_S),
              "bwd least": bound(3 * tensor, 0, F32_FLOPS_PER_S),
              "bwd two passes": bound(5 * tensor, 0, F32_FLOPS_PER_S)}

    def show(t):
        return f"{t['ms']:.4f} ms (loop {t['loop_ms']:.4f})"

    log("train", f"GroupNorm + ReLU at {list(GN_TRAIN_SHAPE)} bf16, f32 parameters, on the "
        f"device (loop): forward + backward K2s+K2a+K2r+K2d {show(pair['route'])}, K2s+K2a + "
        f"the registered gradients {show(pair['registered'])}, F.group_norm + F.relu + "
        f"autograd {show(pair['library'])}; byte bound {bounds['fwd+bwd']['bound_ms']:.4f} ms "
        "(x, dy read once; y, dx written once)")
    log("train", f"  backward alone: K2r+K2d {show(backward['route'])}, the registered "
        f"gradients {show(backward['registered'])}, autograd's {show(backward['library'])}; "
        f"bounds {bounds['bwd least']['bound_ms']:.4f} ms (x, dy read once, dx written once), "
        f"{bounds['bwd two passes']['bound_ms']:.4f} ms (two passes, the mask recomputed); "
        f"aten.native_group_norm_backward (NCHW, no ReLU) {show(lib_pair)}")
    for name, t, outputs in (("K2r", k2r, "dscale, dbias"), ("K2d", k2d, "dx")):
        log("train", f"  {name} alone {show(t)}, bound {t['bound_ms']:.4f} "
            f"({t['bound_ms'] / t['ms'] * 100:.1f}%), plain {t['plain_ms']:.4f} ms, "
            f"native_group_norm_backward ({outputs}) {t['library_ms']:.4f} ms")
    common = {"shape": f"B={b} {h}x{w}x{c} G={g} bf16, f32 params, ReLU",
              "pair_train_ms": pair["route"]["ms"],
              "pair_train_registered_ms": pair["registered"]["ms"],
              "pair_train_library_ms": pair["library"]["ms"],
              "backward_ms": backward["route"]["ms"],
              "backward_registered_ms": backward["registered"]["ms"],
              "backward_library_ms": backward["library"]["ms"],
              "backward_bound_ms": bounds["bwd two passes"]["bound_ms"]}
    return {"gn_backward_sums": {"max_abs_err": k2r_err, **k2r, **common},
            "gn_backward_dx": {"max_abs_err": 0.0, **k2d, **common}}


def train_kernels_vs_plain(dev, cfg, tcfg, batch) -> None:
    """One step of two trainers from one seed, the GroupNorm kernels (K2s,
    K2a, K2r, K2d) on and off, in bf16 and in float32 (TF32 off): every loss
    term and every parameter's gradient within ``TRAIN_KERNEL_TOL``."""
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
            if any(counts[k] != want for k in GN_TRAIN_KERNELS):
                raise AssertionError(f"train step kernels={on}: launches {counts}, expected "
                                     f"K2s, K2a, K2r and K2d {want} each")
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


def train_step_profile(trainer, state, batch, tag: str = "train") -> dict:
    """One step under torch.profiler: the top 10 kernels by device time, the
    share of K2s and K2a (the forward's GroupNorms) and of K2r and K2d (the
    GroupNorm backward), read from the kernels' names; the device time of
    the plain gradients registered on the forward ops, from their profiler
    ranges (none on this route); and the gradients that reached the
    backward in another layout (``group_norm.dy_copies``). Logged under
    ``tag``; returns the step's kernel ms and the two GroupNorm shares."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from handnet_tpu_torch.ops.cuda_gn import GN_BACKWARD_RANGES, group_norm

    torch.cuda.synchronize()
    copies = group_norm.dy_copies
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.train_step(state, batch)
        torch.cuda.synchronize()
    copies = group_norm.dy_copies - copies
    events = prof.key_averages()
    kernels = sorted(((e.key, getattr(e, "self_device_time_total",
                                      getattr(e, "self_cuda_time_total", 0)) / 1e3, e.count)
                      for e in events
                      if "CUDA" in str(getattr(e, "device_type", ""))
                      and not getattr(e, "is_user_annotation", False)
                      and e.key not in GN_BACKWARD_RANGES), key=lambda r: -r[1])
    total = sum(ms for _, ms, _ in kernels)

    def share(*names):
        rows = [(ms, n) for key, ms, n in kernels if any(name in key for name in names)]
        return sum(ms for ms, _ in rows), sum(n for _, n in rows)

    gn_fwd, n_fwd = share("gn_stats_kernel", "gn_apply_kernel")
    gn_bwd, n_bwd = share("gn_backward_sums_kernel", "gn_backward_dx_kernel")
    registered = sum(getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0)) / 1e3
                     for e in events if e.key in GN_BACKWARD_RANGES
                     and "CPU" in str(getattr(e, "device_type", "")))
    if total <= 0:
        log(tag, "profile of one step: the profiler recorded no device time (not measured)")
        return {}
    log(tag, f"profile of one step: kernels {total:.3f} ms on the device "
        f"({sum(n for _, _, n in kernels)} launches); K2s + K2a (forward) {gn_fwd:.3f} ms = "
        f"{100 * gn_fwd / total:.2f}% ({n_fwd} launches); K2r + K2d (the GroupNorm backward) "
        f"{gn_bwd:.3f} ms = {100 * gn_bwd / total:.2f}% ({n_bwd} launches); the registered "
        f"plain gradients {registered:.3f} ms; gradients copied to NHWC before K2r/K2d: "
        f"{copies}")
    for key, ms, count in kernels[:10]:
        log(tag, f"  {ms:9.3f} ms {100 * ms / total:6.2f}%  x{count:<4d} {key[:110]}")
    return {"kernels_ms": total, "gn_forward_ms": gn_fwd, "gn_backward_ms": gn_bwd,
            "dy_copies": copies}


def phase_train(dev, cfg) -> dict:
    """``FCOSTrainer`` at the full width of the 100DOH run (800x1088,
    ResNet-34, FPN 256, 4-conv GN towers, ext heads, 3 classes; batch 8,
    SGD lr 1.25e-3 with warmup, bf16, batch-norm backbone) on a seeded
    synthetic batch, after K2r and K2d against their plain versions.
    Returns the kernels' launches per train step (``per_step``), the
    learning run's launches (``launches``) and K2r's and K2d's JSON
    numbers (``results``)."""
    import torch

    from handnet_tpu_torch.config import TrainConfig
    from handnet_tpu_torch.models.fcos import anchors_for, match_anchors
    from handnet_tpu_torch.train.trainer import FCOSTrainer

    checks = gn_backward_kernel_checks(dev)
    free_device_memory(dev)
    gn_train_gradient(dev)
    results = gn_train_yardstick(dev, checks["err"])
    for name, rows in checks["backbone"].items():
        results[name]["backbone_shapes"] = rows
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
    want = expected_launches(TRAIN_STEPS, GN_LAYERS_PER_CALL, gn_backward=GN_LAYERS_PER_CALL)
    want["a2j_decode"] = 0
    if launches != want:
        raise AssertionError(f"train: launches {launches} over {TRAIN_STEPS} steps: expected K2s, "
                             f"K2a, K2r and K2d {GN_LAYERS_PER_CALL} per step, no K1 or K3")
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
    profile = train_step_profile(trainer, state, batch)
    for name in ("gn_backward_sums", "gn_backward_dx"):
        results[name]["step_profile"] = profile
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
    return {"per_step": per_call(launches, TRAIN_STEPS), "launches": launches,
            "results": results}


# --- data parallel: train_fcos under torchrun, two ranks on the card, the mesh server ---

DDP_CLI_SEQUENCES = 8             # synthetic sequences x 4 frames: 3 steps of batch 8
DDP_CLI_WORKERS = 4
DDP_RANKS = 2                     # gloo ranks sharing the one card
DDP_TIMEOUT_S = 240               # every collective's, and the ranks' join
# a DDP step against the whole-batch step in float32 (TF32 off): another
# batching of the same sums, whose rounding the backbones' BatchNorms
# amplify (tests/test_torch_port_parallel.py: 1e-3 of FCOS's first conv's
# gradient at 64x96; equal to 1e-13 in float64). The relative L2 error of
# the gradients, the running statistics and FCOS's update: FCOS 1e-2; A2J
# 5e-2, the tolerance tests/test_parallel.py gives JAX's own mesh step
# against its one-device step on this graph (its measured floor: 2%). A
# wrong normalizer or unsynchronized statistics move the losses and the
# running statistics by far more than DDP_LOSS_TOL.
DDP_LOSS_TOL = 1e-4               # relative, each loss term
DDP_GRAD_TOL = {"fcos": 1e-2, "a2j": 5e-2}
DDP_SERVE_FRAMES = 264            # 2 dispatches of 128 and one of 8, queued before start


def ddp_setup() -> dict:
    """[ddp]'s models and batches: the [train] FCOS (800x1088, 3 classes)
    on its batch of 8 frames, and A2J at the recipe (176^2, 21 joints) on a
    [train_a2j] batch of 64 crops."""
    from handnet_tpu_torch.config import A2JConfig, load_config

    return {"fcos": load_config().fcos, "a2j": A2JConfig(), "a2j_batch": A2J_TRAIN_BATCH}


def ddp_batches(dev, setup: dict) -> dict:
    """[ddp]'s global batches on ``dev``."""
    a2j = setup["a2j"]
    batch = a2j_train_batch(setup["a2j_batch"], SEED, a2j.crop_h, a2j.num_joints)
    return {"fcos": train_batch(dev, setup["fcos"], SEED),
            "a2j": {k: v.to(dev) for k, v in batch.items()}}


def ddp_steps(dev, mesh, setup: dict) -> dict:
    """One float32 step of ``FCOSTrainer`` (batch-norm backbone, SGD) and
    one of ``A2JTrainer`` (batch-norm A2J, AdamW) at ``setup``'s widths on
    ``mesh``'s shard of [ddp]'s batches (the whole batches without a mesh),
    then A2J's eval step on the shard: per trainer the losses, every
    gradient as the optimizer received it, every parameter before and after
    and every buffer (the running statistics) after, each flattened in
    order, and the launches of the step (of the eval step)."""
    import torch

    from handnet_tpu_torch.config import TrainConfig
    from handnet_tpu_torch.parallel import shard_batch
    from handnet_tpu_torch.train.trainer import A2JTrainer, FCOSTrainer

    batches = ddp_batches(dev, setup)
    if mesh is not None:
        batches = {k: shard_batch(mesh, v)[0] for k, v in batches.items()}
    trainers = {
        "fcos": FCOSTrainer(setup["fcos"],
                            TrainConfig(batch_size=TRAIN_BATCH, lr=TRAIN_LR, optimizer="sgd",
                                        warmup_epochs=1, bf16=False),
                            mesh=mesh, backbone_norm="batch", device=dev),
        "a2j": A2JTrainer(setup["a2j"], TrainConfig(batch_size=setup["a2j_batch"], bf16=False),
                          mesh=mesh, device=dev)}
    def flat(tensors):
        return torch.cat([t.detach().flatten().float() for t in tensors]).cpu()

    out = {}
    for name, trainer in trainers.items():
        state = trainer.init_state(SEED)
        params0 = flat(state.model.parameters())
        grads = []
        step = state.optimizer.step

        def capture(*a, _state=state, _step=step, **k):
            grads.append(torch.cat([p.grad.flatten() for p in _state.model.parameters()]))
            return _step(*a, **k)

        state.optimizer.step = capture
        reset_launch_counts()
        state, metrics = trainer.train_step(state, batches[name])
        device_sync(dev)
        out[name] = {"losses": {k: float(v) for k, v in metrics.items()},
                     "grads": grads[0].float().cpu(), "launches": launch_counts(),
                     "params0": params0, "params": flat(state.model.parameters()),
                     "buffers": flat(state.model.buffers())}
        if name == "a2j":   # the eval step on the inner module, K1 once
            reset_launch_counts()
            trainer.eval_step(state, batches[name])
            device_sync(dev)
            out[name]["eval_launches"] = launch_counts()
        del trainer, state
        free_device_memory(dev)
    return out


def ddp_rank(rank: int, init_file: str, out_dir: str, device: str, setup: dict) -> None:
    """One of [ddp]'s gloo ranks on the one card (NCCL refuses two ranks on
    one device, so gloo is asked for): :func:`ddp_steps` on its shard.
    Rank 0 saves all, the other rank its losses, launches and parameters'
    checksum."""
    import datetime
    import os

    import torch

    from handnet_tpu_torch.parallel import init_data_parallel

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = init_data_parallel("gloo", rank=rank, world_size=DDP_RANKS,
                              init_method=f"file://{init_file}", device=device,
                              timeout=datetime.timedelta(seconds=DDP_TIMEOUT_S))
    try:
        out = ddp_steps(mesh.device, mesh, setup)
        if rank:
            out = {k: {**v, "grads": None, "params0": None, "buffers": None,
                       "params": float(v["params"].double().sum())} for k, v in out.items()}
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def rel_l2(got, want) -> float:
    return float((got.double() - want.double()).norm() / want.double().norm())


def ddp_two_ranks(dev, work: str, setup: dict) -> dict:
    """Two gloo ranks on the card, each stepping on half of [ddp]'s batches,
    against the one-process whole-batch steps. Returns the launches per
    rank and step."""
    import os

    import torch
    import torch.multiprocessing as mp

    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    start = time.perf_counter()
    whole = ddp_steps(dev, None, setup)
    whole_s = time.perf_counter() - start
    start = time.perf_counter()
    ctx = mp.start_processes(ddp_rank, args=(os.path.join(work, "init"), work, str(dev), setup),
                             nprocs=DDP_RANKS, join=False, start_method="spawn")
    deadline = time.monotonic() + DDP_TIMEOUT_S
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise AssertionError("ddp: the two ranks did not finish in time")
    ranks_s = time.perf_counter() - start
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
             for r in range(DDP_RANKS)]
    paths = {}
    for name, want in whole.items():
        got = ranks[0][name]
        if any(r[name]["losses"] != got["losses"] for r in ranks[1:]):
            raise AssertionError(f"ddp {name}: the ranks report different losses")
        if any(r[name]["params"] != float(got["params"].double().sum()) for r in ranks[1:]):
            raise AssertionError(f"ddp {name}: the ranks end with different parameters")
        if not torch.equal(got["params0"], want["params0"]):
            raise AssertionError(f"ddp {name}: the ranks start from other parameters")
        loss_err = max(abs(got["losses"][k] - w) / max(abs(w), 1e-6)
                       for k, w in want["losses"].items())
        errs = {"gradients": rel_l2(got["grads"], want["grads"]),
                "running statistics": rel_l2(got["buffers"], want["buffers"])}
        if name == "fcos":   # SGD: the update is linear in the gradient
            errs["update"] = rel_l2(got["params"] - got["params0"],
                                    want["params"] - want["params0"])
        if not (loss_err <= DDP_LOSS_TOL and max(errs.values()) <= DDP_GRAD_TOL[name]):
            raise AssertionError(f"ddp {name}: 2 ranks vs the whole batch: losses {loss_err:.3e} "
                                 f"(tol {DDP_LOSS_TOL:g}), relative L2 errors {errs} (tol "
                                 f"{DDP_GRAD_TOL[name]:g})")
        launches = [r[name]["launches"] for r in ranks]
        expect = ({**{k: 0 for k in want["launches"]},
                   **{k: GN_LAYERS_PER_CALL for k in GN_TRAIN_KERNELS}}
                  if name == "fcos" else {k: 0 for k in want["launches"]})
        if any(l != expect for l in launches) or want["launches"] != expect:
            raise AssertionError(f"ddp {name}: launches per rank {launches}, whole batch "
                                 f"{want['launches']} (expected {expect})")
        paths[f"ddp_gloo_{name}"] = launches[0]
        msg = ""
        if name == "a2j":
            evals = [r[name]["eval_launches"] for r in ranks]
            k1 = {**{k: 0 for k in evals[0]}, "a2j_decode": 1}
            if any(e != k1 for e in evals):
                raise AssertionError(f"ddp a2j: eval launches per rank {evals} (expected {k1})")
            paths["ddp_gloo_eval_a2j"] = evals[0]
            msg = "; the eval step on each rank's inner module: K1 once"
        log("ddp", f"{DDP_RANKS} gloo ranks on the card (CUDA tensors), {name} float32 (TF32 "
            f"off): losses within {loss_err:.2e} of the whole-batch step (tol "
            f"{DDP_LOSS_TOL:g}), relative L2 errors "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
            + f" (tol {DDP_GRAD_TOL[name]:g}), the ranks' losses and parameters equal; launches "
            f"per rank and step {launches[0]}{msg}")
    log("ddp", f"whole-batch steps {whole_s:.1f} s, the two ranks (spawn, CUDA init, both "
        f"steps) {ranks_s:.1f} s")
    return paths


def ddp_cli_runs(dev, work: str, device_arg: str = "cuda", image=(800, 1088)) -> dict:
    """apps/train_fcos.py at the recipe (800x1088, batch 8, bf16, batch-norm
    backbone) for one epoch on a synthetic tree: without torchrun (once to
    warm up, then timed), as one NCCL rank (the torchrun environment, in
    this process: its launches are counted), and under ``python -m
    torch.distributed.run --nproc-per-node 1 -m
    handnet_tpu_torch.apps.train_fcos``. The epoch's losses (metrics.json)
    and the checkpoint must equal the plain run's. Returns the launches per
    step."""
    import json as json_
    import os
    import socket
    import subprocess as sp

    import torch

    from handnet_tpu_torch.apps import train_fcos
    from handnet_tpu_torch.data.synthetic import make_synthetic_dexycb

    root = os.path.join(work, "tree")
    make_synthetic_dexycb(root, n_sequences=DDP_CLI_SEQUENCES, n_frames=4)
    argv = ["--data-dir", root, "--synthetic", str(DDP_CLI_SEQUENCES), "--epochs", "1",
            "--batch", str(TRAIN_BATCH), "--workers", str(DDP_CLI_WORKERS),
            "--image-h", str(image[0]), "--image-w", str(image[1]), "--device", device_arg]

    def in_process(name: str, env: dict) -> tuple:
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            reset_launch_counts()
            res = train_fcos.main(argv + ["--output", os.path.join(work, name)])
            device_sync(dev)
            return res["epochs"][0], launch_counts()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    def outputs(name: str) -> tuple:
        with open(os.path.join(work, name, "metrics.json")) as f:
            metrics = json_.load(f)
        ckpt = torch.load(os.path.join(work, name, "checkpoints", "0.pt"), map_location="cpu",
                          weights_only=True)
        return metrics, ckpt["model"]

    def max_diff(a: dict, b: dict) -> float:
        if a.keys() != b.keys():
            raise AssertionError("ddp train_fcos: checkpoints with other keys")
        return max(float((a[k].double() - b[k].double()).abs().max()) for k in a)

    in_process("warm-up", {})   # the codec's first build, the first decodes
    plain, plain_launches = in_process("plain", {})
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    nccl, nccl_launches = in_process("nccl", {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                                              "MASTER_ADDR": "127.0.0.1",
                                              "MASTER_PORT": str(port)})
    if torch.distributed.is_initialized():
        raise AssertionError("ddp train_fcos: the CLI left its process group")
    start = time.perf_counter()
    proc = sp.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                   "--nproc-per-node", "1", "-m", "handnet_tpu_torch.apps.train_fcos", *argv,
                   "--output", os.path.join(work, "torchrun")],
                  capture_output=True, text=True, timeout=DDP_TIMEOUT_S)
    torchrun_s = time.perf_counter() - start
    if proc.returncode:
        raise AssertionError(f"ddp: torchrun train_fcos exited {proc.returncode}:\n"
                             f"{proc.stderr[-3000:]}")
    steps = plain["steps"]
    ref_metrics, ref_model = outputs("plain")
    for name in ("nccl", "torchrun"):
        metrics, model = outputs(name)
        diff = max_diff(model, ref_model)
        if metrics != ref_metrics or diff:
            raise AssertionError(f"ddp train_fcos {name}: metrics {metrics} vs {ref_metrics}, "
                                 f"checkpoint max |diff| {diff:.3e}")
    want = {**{k: 0 for k in plain_launches},
            **{k: GN_LAYERS_PER_CALL * steps for k in GN_TRAIN_KERNELS}}
    if plain_launches != want or nccl_launches != want or nccl["steps"] != steps:
        raise AssertionError(f"ddp train_fcos: launches {plain_launches} plain, {nccl_launches} "
                             f"one NCCL rank, over {steps} steps (expected {want})")
    log("ddp", f"train_fcos at {TRAIN_BATCH} x {image[0]}x{image[1]}, bf16, {steps} steps: one rank "
        f"(torchrun's environment, in this process) and `python -m torch.distributed.run "
        f"--nproc-per-node 1 -m handnet_tpu_torch.apps.train_fcos` ({torchrun_s:.1f} s with "
        f"its start) == the run without torchrun: metrics.json and every checkpoint tensor "
        f"bit for bit; launches per step {per_call(nccl_launches, steps)}")
    log("ddp", f"ms per step (the CLI's loop clock, {steps} steps with the first, loader "
        f"included, after a warm-up run): {plain['ms_per_step']:.1f} without DDP, "
        f"{nccl['ms_per_step']:.1f} as one NCCL rank")
    return {"ddp_train_fcos_nccl": per_call(nccl_launches, steps)}


def ddp_mesh_server(dev, cfg, smi: str) -> dict:
    """``PipelineServer(mesh=create_mesh(1))`` at fast (buckets 8 and 128,
    bf16) against the mesh-less server on the same weights and
    :data:`DDP_SERVE_FRAMES` frames queued before each starts (so both
    dispatch 128, 128 and 8): every result bit for bit. Returns the
    launches per warm-up or capture call."""
    import numpy as np

    from handnet_tpu_torch.apps.serve import PipelineServer
    from handnet_tpu_torch.graphs import WARMUP_CALLS
    from handnet_tpu_torch.models.pipeline import HandNetPipeline
    from handnet_tpu_torch.parallel import create_mesh

    state_dict = HandNetPipeline(cfg, dtype=cfg_dtype(dev), device=dev, seed=SEED).state_dict()
    rgb, depth = wire_frames(8, SEED + 7)
    results, fps = {}, {}
    launches = None
    for name, kw in (("one device", {"device": dev}),
                     ("mesh", {"mesh": create_mesh(1, device=dev.type)})):
        server = PipelineServer(cfg, batch_size=128, state_dict=state_dict, frame_hw=(480, 640),
                                dtype=cfg_dtype(dev), batch_buckets=(8, 128), **kw)
        reset_launch_counts()
        server.compile()
        if name == "mesh":
            launches = per_call(launch_counts(), (WARMUP_CALLS + 1) * 2)
        for i in range(DDP_SERVE_FRAMES):
            server.submit(i % 4, i, rgb[i % 8], depth[i % 8])
        server.start()
        try:
            got = {}
            for _ in range(DDP_SERVE_FRAMES):
                sid, fid, out = server.get(timeout=120)
                if "error" in out:
                    raise AssertionError(f"ddp serve {name}: {out['error']}")
                got[fid] = out
        finally:
            server.stop()
        if server.bucket_dispatches != {8: 1, 128: 2}:
            raise AssertionError(f"ddp serve {name}: dispatches {server.bucket_dispatches}")
        results[name], fps[name] = got, server.sustained_fps
        del server
        free_device_memory(dev)
    for fid, want in results["one device"].items():
        got = results["mesh"][fid]
        if got.keys() != want.keys() or not all(np.array_equal(got[k], want[k]) for k in want):
            raise AssertionError(f"ddp serve: frame {fid} differs between the mesh server and "
                                 "the one-device server")
    want = {**{k: 0 for k in launches}, "a2j_decode": 1, "gn_group_stats": GN_LAYERS_PER_CALL,
            "gn_apply": GN_LAYERS_PER_CALL}
    if launches != want:
        raise AssertionError(f"ddp serve: launches per capture call {launches} (expected {want})")
    log("ddp", f"PipelineServer(mesh=create_mesh(1)) at fast, buckets 8/128, bf16: "
        f"{DDP_SERVE_FRAMES} frames == the one-device server bit for bit (dispatches 128, 128, "
        f"8 each); launches per warm-up or capture call {launches}; sustained_fps "
        f"{fps['one device']:.1f} one device, {fps['mesh']:.1f} mesh on {smi}")
    return {"ddp_serve_mesh": launches}


def phase_ddp(dev, cfg, smi: str, device_arg: str = "cuda", setup=None,
              cli_image=(800, 1088)) -> dict:
    """Data parallelism on the one card: train_fcos as one NCCL rank and
    under torchrun against the plain CLI, two gloo ranks against the
    whole-batch steps, and the mesh server against the one-device server.
    Returns the launches per step or call of each path."""
    import tempfile

    paths = {}
    with tempfile.TemporaryDirectory() as work:
        paths.update(ddp_cli_runs(dev, work, device_arg, cli_image))
        free_device_memory(dev)
        paths.update(ddp_two_ranks(dev, work, setup or ddp_setup()))
        free_device_memory(dev)
    paths.update(ddp_mesh_server(dev, cfg, smi))
    return paths


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


def step_profile(tag: str, name: str, fn, top: int = 10) -> float:
    """One call of ``fn`` (a train step) under torch.profiler: the top
    ``top`` kernels by device time; returns the call's kernel ms (nan where
    the profiler recorded none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = sorted(device_rows(prof), key=lambda r: -r[1])
    total = sum(ms for _, ms, _ in kernels)
    if total <= 0:
        log(tag, f"{name}: the profiler recorded no device time (not measured)")
        return float("nan")
    log(tag, f"{name}: kernels {total:.3f} ms on the device, "
        f"{sum(n for _, _, n in kernels)} launches")
    for key, ms, count in kernels[:top]:
        log(tag, f"  {ms:9.3f} ms {100 * ms / total:6.2f}%  x{count:<4d} {key[:110]}")
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
    kernel_ms = step_profile("train_a2j", "profile of one step",
                             lambda: trainer.train_step(state, batch))
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
    want = {**{k: 0 for k in launches},
            **{k: GN_LAYERS_PER_CALL * steps for k in GN_TRAIN_KERNELS}}
    log_epochs("train_fcos", res)
    losses = [e["losses"] for e in res["epochs"]]
    if launches != want or not all(np.isfinite(list(l.values())).all() for l in losses):
        raise AssertionError(f"train_fcos: launches {launches} over {steps} steps (expected "
                             f"{want}), losses {losses}")
    log("fcos_apps", f"train_fcos: {res['samples']} samples, {steps} steps, launches "
        f"{launches}: K2s/K2a/K2r/K2d {GN_LAYERS_PER_CALL} per step, nothing else; losses "
        "finite")
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
    want = {**{k: 0 for k in launches}, **{k: per_step * steps for k in GN_TRAIN_KERNELS}}
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
    log("fcos_apps", f"train_fcos --voc-root, GroupNorm backbone: {steps} steps, "
        f"K2s/K2a/K2r/K2d {per_step} per step ({GN_LAYERS_PER_CALL} head + "
        f"{BACKBONE_GN_LAYERS} backbone), "
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
    device memory: checks that K2s, K2a, K2r and K2d launched
    ``per_step_gn`` times per step and nothing else did, and that every
    epoch's mean loss is finite (``main`` itself exits at the first step
    whose loss is not). Returns ``(result, launches per step)``."""
    import numpy as np
    import torch

    from handnet_tpu_torch.apps import train_fcos

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    res = train_fcos.main(argv)
    torch.cuda.synchronize()
    launches = launch_counts()
    steps = sum(e["steps"] for e in res["epochs"])
    want = {**{k: 0 for k in launches}, **{k: per_step_gn * steps for k in GN_TRAIN_KERNELS}}
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
        f"launches {launches}: K2s/K2a/K2r/K2d {per_step_gn} per step, nothing else; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
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
    ours) and on its VOC tree with the GroupNorm backbone (K2s, K2a, K2r and
    K2d 36 per step), the trained GroupNorm backbone's pyramid and RPN objectness with
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


A2J_2D_BATCHES = (1, 8, 128)      # K1xy against its plain version
A2J_2D_PREDICT_CALLS = 3          # 2D A2JSystem.predict calls of batch 128, bf16
A2J_2D_TRAIN_STEPS = 3            # 2D A2JTrainer steps at batch 64, bf16
A2J_2D_CPU_BATCH = 2              # the float32 card path against the CPU
A2J_2D_CPU_TOL = 1e-3             # of the UV scale: the same float32 forward, TF32 off


def a2j_heads(gen, dev, b: int, dtype, n: int = 1936, p: int = 21):
    """Seeded head tensors of K1's checks: cls ``[B, N, P]``, reg
    ``[B, N, P, 2]`` and depth ``[B, N, P]`` (as :func:`phase_a2j_kernel`)."""
    import torch

    return ((torch.randn(b, n, p, device=dev, generator=gen) * 2).to(dtype),
            (torch.randn(b, n, p, 2, device=dev, generator=gen) * 5).to(dtype),
            torch.randn(b, n, p, device=dev, generator=gen).to(dtype))


def k1_output_hash(dev) -> str:
    """SHA-256 of the 3D K1's output at the main path's shape (B=128,
    N=1936, P=21, bf16) on heads drawn from a generator seeded with
    ``SEED``: a checkout whose K1 computes as before prints the same hash
    (``k12_device_times.py --k1-hash --root DIR`` prints another checkout's)."""
    import torch

    from handnet_tpu_torch.ops.anchors import a2j_anchor_grid
    from handnet_tpu_torch.ops.cuda_a2j import a2j_decode

    gen = torch.Generator(device=dev).manual_seed(SEED)
    anchors = torch.from_numpy(a2j_anchor_grid(11, 11, 16)).to(dev)
    return output_hash(a2j_decode(*a2j_heads(gen, dev, 128, torch.bfloat16), anchors))


def phase_a2j_xy_kernel(dev) -> dict:
    """K1xy (the 2D A2J's decode) against its plain version at B = 1, 8 and
    128, float32 and bf16, two runs bit-equal, an unaligned shape and
    strided views refused; K1's output hash. Returns the numbers of K1xy's
    JSON entry (everything but the launch count)."""
    import torch

    from handnet_tpu_torch.ops.anchors import a2j_anchor_grid
    from handnet_tpu_torch.ops.cuda_a2j import a2j_decode_xy, a2j_decode_xy_reference

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    n, p = 1936, 21
    anchors = torch.from_numpy(a2j_anchor_grid(11, 11, 16)).to(dev)

    def compare(name, cls, reg, anc):
        # tolerance 1e-4 of the coordinate scale: float32 sums in another
        # order on the same (bf16-rounded) inputs
        want = a2j_decode_xy_reference(cls, reg, anc)
        tol = 1e-4 * max(1.0, want.abs().max().item())
        got = same_bits_twice(name, lambda: a2j_decode_xy(cls, reg, anc))
        return check(name, got, want, tol), tol

    errs, times = [], {}
    for b in A2J_2D_BATCHES:
        for dtype in (torch.float32, torch.bfloat16):
            c, r, _ = a2j_heads(gen, dev, b, dtype)
            err, tol = compare(f"K1xy B={b} {dtype}", c, r, anchors)
            errs.append(err)
            kernel = timed(lambda: a2j_decode_xy(c, r, anchors))
            line = (f"K1xy a2j_decode_xy B={b} N={n} P={p} {dtype}: max|err| {err:.3e} (tol "
                    f"{tol:.1e}), two runs bit-equal; kernel on the device {kernel['ms']:.4f} "
                    f"ms, wrapper loop {kernel['loop_ms']:.4f} ms")
            if b == 128:
                plain = timed(lambda: a2j_decode_xy_reference(c, r, anchors))
                times[dtype] = (kernel, plain, nbytes(c, r))
                line += (f"; plain on the device {plain['ms']:.4f} ms, loop "
                         f"{plain['loop_ms']:.4f} ms")
            log("a2j_2d", line)
    odd_anchors = torch.randn(50, 2, device=dev, generator=gen) * 40
    for dtype in (torch.float32, torch.bfloat16):
        c, r, _ = a2j_heads(gen, dev, 3, dtype, 50, 7)
        errs.append(compare(f"K1xy N=50 P=7 {dtype}", c, r, odd_anchors)[0])
    log("a2j_2d", f"K1xy N=50 P=7 B=3 (unaligned runs, element-wise staging) f32 and bf16: "
        f"max|err| {max(errs[-2:]):.3e}")
    c, r, _ = a2j_heads(gen, dev, 8, torch.float32)
    refused = 0
    for args in ((torch.randn(8, p, n, device=dev, generator=gen).transpose(1, 2), r),
                 (c, torch.randn(8, n, p, 4, device=dev, generator=gen)[..., ::2])):
        try:
            a2j_decode_xy(*args, anchors)
        except ValueError as exc:
            refused += "must be contiguous" in str(exc)
    if refused != 2:
        raise AssertionError("K1xy: a strided cls or reg view was not refused")
    log("a2j_2d", "K1xy strided cls and reg views: refused with ValueError (no silent copy)")
    log("a2j_2d", f"K1 (3D) output hash at B=128 N={n} P={p} bf16, seed {SEED}: "
        f"{k1_output_hash(dev)}")
    kernel, plain, heads_bytes = times[torch.bfloat16]
    # bound at B=128 bf16: cls, reg and the anchors read once, the [B, P, 2]
    # float32 out written once; per (image, anchor, joint) a max, a
    # subtraction, an exp and 3 multiply-adds, counted as 10 float32
    # operations. No single PyTorch call computes it.
    b = 128
    moved = heads_bytes + nbytes(anchors) + b * p * 2 * 4
    result = {"max_abs_err": max(errs), **kernel, "plain_ms": plain["ms"],
              "plain_loop_ms": plain["loop_ms"],
              **bound(moved, 10 * b * n * p, F32_FLOPS_PER_S), "library_ms": None}
    log("a2j_2d", f"K1xy B=128 bf16: bound {result['bound_ms']:.4f} ms ({moved} bytes / 3.35 "
        f"TB/s; by {result['bound_by']}), {result['bound_ms'] / kernel['ms'] * 100:.0f}% of it "
        "reached on the device; no library call")
    return result


def phase_a2j_2d(dev) -> dict:
    """The 2D A2J (``is_3d=False``) at full width: ResNet-50-dilated, 176^2
    crops, 21 joints, three 256-wide towers without the depth head. K1xy
    against its plain version (``phase_a2j_xy_kernel``), then
    ``A2JSystem.predict`` at B=128 bf16 (``A2J_2D_PREDICT_CALLS`` calls: one
    K1xy launch each and no other), the float32 card path against the CPU,
    ``A2J_2D_TRAIN_STEPS`` train steps at batch 64 bf16 and the eval step.
    Returns K1xy's JSON numbers, its launches in the predict run and the
    launches per call of each 2D path."""
    import torch

    from handnet_tpu_torch.config import A2JConfig, TrainConfig
    from handnet_tpu_torch.models.a2j import A2JSystem
    from handnet_tpu_torch.train.trainer import A2JTrainer

    result = phase_a2j_xy_kernel(dev)
    cfg = A2JConfig(is_3d=False)
    model = A2JSystem(cfg)
    model.init_weights_(torch.Generator().manual_seed(SEED))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    model = model.to(dev, memory_format=torch.channels_last).eval()
    crops = a2j_train_batch(128, SEED, cfg.crop_h, cfg.num_joints)["image"].to(dev)

    def predict():
        with torch.inference_mode(), torch.autocast("cuda", dtype=torch.bfloat16):
            return model.predict(crops)

    predict()                                      # cuDNN's set-up
    torch.cuda.synchronize()
    reset_launch_counts()
    outs = [predict() for _ in range(A2J_2D_PREDICT_CALLS)]
    torch.cuda.synchronize()
    launches = launch_counts()
    want = {**{k: 0 for k in launches}, "a2j_decode_xy": A2J_2D_PREDICT_CALLS}
    if launches != want:
        raise AssertionError(f"a2j_2d predict: launches {launches}, expected {want}")
    for out in outs:
        if tuple(out.shape) != (128, cfg.num_joints, 2) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"a2j_2d predict: UV {tuple(out.shape)}, finite "
                                 f"{bool(torch.isfinite(out).all())}")
    if not all(torch.equal(outs[0], o) for o in outs[1:]):
        raise AssertionError("a2j_2d predict: calls on the same crops differ")
    call_ms = cuda_ms(predict, iters=5, warmup=1)
    log("a2j_2d", f"A2JSystem(is_3d=False).predict B=128 bf16 176^2 21 joints: UV "
        f"{tuple(outs[0].shape)} finite, {A2J_2D_PREDICT_CALLS} calls bit-equal; launches "
        f"{per_call(launches, A2J_2D_PREDICT_CALLS)} per call (K1xy once, K1 never); "
        f"{call_ms:.3f} ms per call (CUDA events)")
    del outs

    # float32, TF32 off: the kernel path against the plain path and the CPU
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    x = crops[:A2J_2D_CPU_BATCH].float()
    with torch.inference_mode():
        got = model.predict(x)
        model.use_kernels = False
        plain = model.predict(x)
        model.use_kernels = True
    cpu_model = A2JSystem(cfg)
    cpu_model.load_state_dict(state)
    with torch.inference_mode():
        want_cpu = cpu_model.eval().predict(x.cpu())
    torch.backends.cudnn.allow_tf32 = True
    scale = want_cpu.abs().max().item()
    err_plain = check("a2j_2d K1xy vs plain (card, f32)", got, plain, 1e-4 * scale)
    err_cpu = check("a2j_2d card vs CPU (f32)", got.cpu(), want_cpu, A2J_2D_CPU_TOL * scale)
    log("a2j_2d", f"f32 (TF32 off) B={A2J_2D_CPU_BATCH}: K1xy path == plain path on the card "
        f"within {err_plain:.3e} px (tol 1e-4 of {scale:.1f}), card == CPU run within "
        f"{err_cpu:.3e} px (tol {A2J_2D_CPU_TOL:g} of the scale)")
    del model, cpu_model, crops, x
    free_device_memory(dev)

    # training: A2J_2D_TRAIN_STEPS bf16 steps at the recipe's batch, then
    # the eval step: [B, P, 2] targets through K1xy, [B, P, 3] refused as
    # JAX's eval step fails to broadcast them
    tcfg = TrainConfig(batch_size=A2J_TRAIN_BATCH)
    trainer = A2JTrainer(cfg, tcfg, device=dev)
    train_state = trainer.init_state(SEED)
    batch = {k: v.to(dev) for k, v in
             a2j_train_batch(A2J_TRAIN_BATCH, SEED, cfg.crop_h, cfg.num_joints).items()}
    reset_launch_counts()
    losses = [trainer.train_step(train_state, batch)[1]["total_loss"].item()
              for _ in range(A2J_2D_TRAIN_STEPS)]
    torch.cuda.synchronize()
    train_launches = launch_counts()
    if any(train_launches.values()) or not all(math.isfinite(v) for v in losses) or len(
            set(losses)) != len(losses):
        raise AssertionError(f"a2j_2d train: losses {losses}, launches {train_launches}")
    start = time.perf_counter()
    trainer.train_step(train_state, batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - start) * 1e3
    batch_2d = {"image": batch["image"], "jt_uvd": batch["jt_uvd"][..., :2].contiguous()}
    reset_launch_counts()
    pred, rmse = trainer.eval_step(train_state, batch_2d)
    torch.cuda.synchronize()
    eval_launches = launch_counts()
    if (eval_launches != {**{k: 0 for k in eval_launches}, "a2j_decode_xy": 1}
            or tuple(pred.shape) != (A2J_TRAIN_BATCH, cfg.num_joints, 2)
            or not math.isfinite(rmse.item())):
        raise AssertionError(f"a2j_2d eval: launches {eval_launches}, pred "
                             f"{tuple(pred.shape)}, rmse {rmse.item()}")
    try:
        trainer.eval_step(train_state, batch)
    except ValueError as exc:
        refused = "broadcast" in str(exc)
    else:
        refused = False
    if not refused:
        raise AssertionError("a2j_2d eval: [B, P, 3] targets were not refused")
    log("a2j_2d", f"A2JTrainer 2D, batch {A2J_TRAIN_BATCH} bf16: total loss by step "
        + ", ".join(f"{v:.4f}" for v in losses) + f" (finite, moving); one more step "
        f"{step_ms:.1f} ms (host clock); no launch of ours in training; eval step with "
        f"[B, P, 2] targets: pred {tuple(pred.shape)}, rmse {rmse.item():.4f} px, K1xy once; "
        "[B, P, 3] targets refused with ValueError (JAX's eval step fails to broadcast them)")
    del trainer, train_state, batch, batch_2d
    free_device_memory(dev)
    return {"result": result, "launches": launches["a2j_decode_xy"],
            "paths": {"a2j_2d_predict": per_call(launches, A2J_2D_PREDICT_CALLS),
                      "train_a2j_2d": per_call(train_launches, A2J_2D_TRAIN_STEPS),
                      "eval_a2j_2d": eval_launches}}


# A2J with GroupNorm(32) (A2JSystem(norm="group")): layer3's 1024-channel
# outputs (bn3 x6 and the downsample) and layer4's 2048-channel ones (bn3 x3
# and the downsample) at 11x11 for 176^2 crops, C/G 32 and 64
A2J_GROUP_SHAPES = {(11, 11, 1024, 32): 7, (11, 11, 2048, 32): 4}
A2J_GROUP_BATCHES = (1, 8, 64, 128)  # K2s/K2a at the wide shapes against plain
A2J_GROUP_PREDICT = (64, 128)        # train_a2j's batch and the serving batch
A2J_GROUP_NORMS = 65                 # 53 in the backbone, 12 in the towers
A2J_GROUP_CALLS = 2                  # counted predict calls per batch and dtype
# crops/s against the frozen-BN A2J: turns of A2J_GROUP_TURN calls, the two
# models in alternating order over A2J_GROUP_PAIRS pairs of turns (32 calls a
# model per batch and dtype); a model is ahead only where its slowest turn
# beats the other's fastest
A2J_GROUP_PAIRS = 8
A2J_GROUP_TURN = 4
A2J_GROUP_TOL_F32 = 1e-2             # px: kernel path == plain path, TF32 off
# px, bf16 under autocast: K2s's statistics differ from the plain version's
# in their last bits, so a bf16 rounding of a norm's output flips now and then
# and the flips run through 65 norms (0.6% of the 176 px crop)
A2J_GROUP_TOL_BF16 = 1.0
# A2J-GN's train step (train_a2j's batch) and its GroupNorms' shapes at
# 176^2 crops, G=32: (H, W, C, G) -> layers; the 11x11 ones at C = 256,
# 1024 and 2048 are where K2r and K2d are timed in [a2j_group]
A2J_GROUP_TRAIN_BATCH = 64
A2J_GROUP_TRAIN_SHAPES = {(88, 88, 64, 32): 1, (44, 44, 64, 32): 6, (44, 44, 128, 32): 1,
                          (44, 44, 256, 32): 4, (22, 22, 128, 32): 7, (22, 22, 256, 32): 1,
                          (22, 22, 512, 32): 5, (11, 11, 256, 32): 23, (11, 11, 512, 32): 6,
                          (11, 11, 1024, 32): 7, (11, 11, 2048, 32): 4}
A2J_GROUP_TIMED = ((11, 11, 256, 32), (11, 11, 1024, 32), (11, 11, 2048, 32))
A2J_GROUP_BACKWARD_BATCHES = (1, 8, 64)   # K2r/K2d at the wide shapes against plain
A2J_GROUP_STEPS = 3                  # AdamW updates with the kernels, per dtype
A2J_GROUP_TIMED_STEPS = 5            # steps between two CUDA events, per model
# A2J-GN's train step with the kernels against the same step through the
# plain versions (use_kernels=False: autograd through group_norm_reference),
# one seed and batch: each loss term (relative) and each parameter's
# gradient (norm of the difference over the norm; median and worst over the
# 213 tensors). They differ by the statistics' last bits and by the
# backward's formula and order (K2r + K2d against autograd's), which a
# random ResNet-50 65 norms deep amplifies; cuDNN's weight gradients sum in
# no fixed order. The control is the plain step again with every norm's
# scale times (1 + A2J_GROUP_CONTROL): a move of the size of those last
# bits. float32 (TF32 off) is held to fixed bounds (measured on an H100:
# losses equal, gradients median 9.8e-4, max 7.3e-3; the control 1.4e-3,
# 1.0e-2). In bf16 a last-bit move flips roundings that 65 norms carry to
# every gradient (the control moves them by a median of 0.10 and up to
# 0.43), so there the kernels' gradients are held to ``control`` times the
# control's median and max, measured in the same run (kernels: 9.6e-2,
# 0.400), and the losses to a fixed bound (measured 4.9e-5).
A2J_GROUP_CONTROL = 1e-6
A2J_GROUP_STEP_TOL = {"float32": {"loss": 1e-4, "grad_median": 1e-2, "grad_max": 5e-2},
                      "bfloat16": {"loss": 1e-3, "control": 2.5}}


def a2j_group_kernels(dev) -> dict:
    """K2s and K2a at A2J-GN's wide shapes (``A2J_GROUP_SHAPES``: C/G 32 and
    64, a float32 2048-channel row of 512 chunks) against their plain
    versions at B = 1, 8, 64 and 128, float32 and bfloat16: K2s to 1e-4 of
    scale with two runs bit-equal, K2a bit for bit with parameters in x's
    type and in float32, ReLU on and off; the mean >> std case at both
    widths; at B=128 both timed in both types beside their byte bounds,
    their plain versions, ``torch.var_mean`` and ``F.group_norm``. Returns
    the largest K2s error and the JSON rows by kernel."""
    import torch
    import torch.nn.functional as F

    from handnet_tpu_torch.ops.cuda_gn import (gn_apply, gn_apply_reference, gn_group_stats,
                                               gn_group_stats_reference)

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    eps = 1e-6
    errs, applied = [], 0
    rows = {"gn_group_stats": [], "gn_apply": []}
    for (h, w, c, g), layers in A2J_GROUP_SHAPES.items():
        scale = torch.rand(c, device=dev, generator=gen) + 0.5
        bias = torch.randn(c, device=dev, generator=gen)
        for b in A2J_GROUP_BATCHES:
            x = torch.randn(b, h, w, c, device=dev, generator=gen) * 3 + 2
            for dtype in (torch.float32, torch.bfloat16):
                xd = x.to(dtype)
                name = f"B={b} {h}x{w}x{c} G={g} {dtype}"
                want = gn_group_stats_reference(xd, g)
                tol = 1e-4 * max(1.0, want.abs().max().item())
                stats = same_bits_twice(f"K2s {name}", lambda: gn_group_stats(xd, g))
                errs.append(check(f"K2s {name}", stats, want, tol))
                for params in {dtype, torch.float32}:
                    sc, bi = scale.to(params), bias.to(params)
                    for relu in (False, True):
                        got = same_bits_twice(f"K2a {name}",
                                              lambda: gn_apply(xd, stats, sc, bi, eps, relu))
                        if not torch.equal(got, gn_apply_reference(xd, stats, sc, bi, eps, relu)):
                            raise AssertionError(f"K2a {name} params {params} relu={relu}: not "
                                                 "bit-equal to its plain version")
                        applied += 1
                if b != 128:
                    continue
                sc, bi = scale.to(dtype), bias.to(dtype)
                grouped, xc = xd.view(b, h * w, g, c // g), xd.permute(0, 3, 1, 2)
                t = {"K2s": timed(lambda: gn_group_stats(xd, g)),
                     "K2a": timed(lambda: gn_apply(xd, stats, sc, bi, eps, True)),
                     "K2s plain": timed(lambda: gn_group_stats_reference(xd, g)),
                     "K2a plain": timed(lambda: gn_apply_reference(xd, stats, sc, bi, eps, True)),
                     "torch.var_mean": timed(lambda: torch.var_mean(grouped, dim=(1, 3),
                                                                    correction=0)),
                     "F.group_norm": timed(lambda: F.group_norm(xc, g, sc, bi, eps))}
                # as phase 3: K2s reads x and writes [B, 2, G] float32, 6 float32
                # operations an element; K2a reads x and writes y, 4 an element
                s_bound = bound(nbytes(xd) + b * 2 * g * 4, 6 * xd.numel(), F32_FLOPS_PER_S)
                a_bound = bound(2 * nbytes(xd) + nbytes(stats, sc, bi), 4 * xd.numel(),
                                F32_FLOPS_PER_S)
                kind = "f32" if dtype == torch.float32 else "bf16"
                common = {"shape": f"B={b} {h}x{w}x{c} G={g} {kind}", "layers": layers,
                          "pair_library_ms": t["F.group_norm"]["ms"]}
                rows["gn_group_stats"].append({
                    **common, **t["K2s"], **s_bound, "plain_ms": t["K2s plain"]["ms"],
                    "library_ms": t["torch.var_mean"]["ms"]})
                rows["gn_apply"].append({
                    **common, **t["K2a"], **a_bound, "plain_ms": t["K2a plain"]["ms"],
                    "library_ms": None})
                log("a2j_group", f"{name}: K2s {t['K2s']['ms']:.4f} ms on the device (bound "
                    f"{s_bound['bound_ms']:.4f}, {s_bound['bound_ms'] / t['K2s']['ms']:.0%}), "
                    f"K2a+ReLU {t['K2a']['ms']:.4f} (bound {a_bound['bound_ms']:.4f}, "
                    f"{a_bound['bound_ms'] / t['K2a']['ms']:.0%}); "
                    + ", ".join(f"{k} {v['ms']:.4f}" for k, v in t.items()
                                if k not in ("K2s", "K2a")))
                del grouped, xc
            del x, xd
    # mean >> std at both widths: E[x^2]-E[x]^2 would lose the variance
    for c in (1024, 2048):
        x = 1000.0 + 0.1 * torch.randn(8, 11, 11, c, device=dev, generator=gen)
        got, want = gn_group_stats(x, 32), gn_group_stats_reference(x, 32)
        errs.append(check(f"K2s mean>>std C={c}", got[:, 0], want[:, 0], 2e-3))
        rel = ((got[:, 1] - want[:, 1]).abs() / want[:, 1]).max().item()
        if not rel <= 1e-2 or not bool((got[:, 1] > 0).all()):
            raise AssertionError(f"K2s mean>>std C={c}: variance rel err {rel:.3e} > 1e-2")
    log("a2j_group", f"K2s at C/G 32 and 64 (B={A2J_GROUP_BATCHES}, f32 and bf16): max|err| "
        f"{max(errs):.3e} within 1e-4 of scale, two runs bit-equal, mean>>std held; K2a: "
        f"{applied} comparisons bit-equal to gn_apply_reference and two runs bit-equal")
    return {"err": max(errs), "rows": rows}


def a2j_group_backward_kernels(dev) -> dict:
    """K2r and K2d at A2J-GN's wide shapes (C/G 32 and 64; a float32
    2048-channel row of 512 chunks) against their plain versions at B = 1,
    8 and 64, float32 and bfloat16, parameters in float32 (as the trainer
    holds them) and in x's type, ReLU on and off: K2r's sums and dparams
    to 1e-5 of their scale and two launches bit-equal; K2d bit for bit
    against its plain version on K2r's sums and two launches bit-equal. The
    mean >> std case at both widths. At B=64 (train_a2j's batch) both timed
    at ``A2J_GROUP_TIMED`` in both types (:func:`gn_backward_times`: device
    and loop ms, byte bound, plain versions, ``native_group_norm_backward``
    for the same outputs). Returns K2r's largest absolute error and the
    JSON rows by kernel."""
    import torch

    from handnet_tpu_torch.ops.cuda_gn import (gn_backward_dx, gn_backward_dx_reference,
                                               gn_backward_sums, gn_backward_sums_reference,
                                               gn_group_stats)

    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    eps = 1e-6
    worst, worst_abs, cases = {"sums": 0.0, "dparams": 0.0}, 0.0, 0
    rows = {"gn_backward_sums": [], "gn_backward_dx": []}

    def hold(name, xd, dyd, stats, sc, bi, relu):
        nonlocal worst_abs, cases
        runs = [gn_backward_sums(xd, dyd, stats, sc, bi, eps, relu) for _ in range(2)]
        if output_hash(*runs[0]) != output_hash(*runs[1]):
            raise AssertionError(f"K2r {name}: two runs differ")
        want = gn_backward_sums_reference(xd, dyd, stats, sc, bi, eps, relu)
        for key, got, ref in zip(("sums", "dparams"), runs[0], want):
            scale_of = ref.abs().max().item()
            worst_abs = max(worst_abs, check(f"K2r {key} {name}", got, ref, 1e-5 * scale_of))
            worst[key] = max(worst[key], ((got - ref).abs().max() / scale_of).item())
        sums = runs[0][0]
        dx = same_bits_twice(f"K2d {name}",
                             lambda: gn_backward_dx(xd, dyd, stats, sc, bi, sums, eps, relu))
        if dx.dtype != xd.dtype or not torch.equal(
                dx, gn_backward_dx_reference(xd, dyd, stats, sc, bi, sums, eps, relu)):
            raise AssertionError(f"K2d {name}: not bit-equal to its plain version on K2r's sums")
        cases += 1

    shapes = [s for s in A2J_GROUP_TIMED if s[2] // s[3] >= 32]
    for h, w, c, g in A2J_GROUP_TIMED:
        scale = torch.rand(c, device=dev, generator=gen) + 0.5
        bias = torch.randn(c, device=dev, generator=gen)
        for b in A2J_GROUP_BACKWARD_BATCHES:
            if (h, w, c, g) not in shapes and b != A2J_GROUP_TRAIN_BATCH:
                continue                                   # C/G 8: timed only
            x = torch.randn(b, h, w, c, device=dev, generator=gen) * 3 + 2
            dy = torch.randn(b, h, w, c, device=dev, generator=gen)
            for dtype in (torch.float32, torch.bfloat16):
                xd, dyd = x.to(dtype), dy.to(dtype)
                stats = gn_group_stats(xd, g)
                if (h, w, c, g) in shapes:
                    for params in {dtype, torch.float32}:
                        for relu in (False, True):
                            hold(f"B={b} {h}x{w}x{c} G={g} {dtype} params {params} relu={relu}",
                                 xd, dyd, stats, scale.to(params), bias.to(params), relu)
                if b == A2J_GROUP_TRAIN_BATCH:
                    t = gn_backward_times(xd, dyd, stats, scale, bias, g, eps)
                    kind = "f32" if dtype == torch.float32 else "bf16"
                    for key, row in t.items():
                        rows[key].append({"shape": f"B={b} {h}x{w}x{c} G={g} {kind}, f32 params, "
                                                   "ReLU",
                                          "layers": A2J_GROUP_TRAIN_SHAPES[(h, w, c, g)], **row})
                    log("a2j_group", f"B={b} {h}x{w}x{c} G={g} {kind}, f32 params, ReLU: " + "; ".join(
                        f"{'K2r' if key == 'gn_backward_sums' else 'K2d'} {r['ms']:.4f} ms on the "
                        f"device (loop {r['loop_ms']:.4f}), bound {r['bound_ms']:.4f} "
                        f"({r['bound_ms'] / r['ms']:.0%}), plain {r['plain_ms']:.4f}, "
                        f"native_group_norm_backward {r['library_ms']:.4f}"
                        for key, r in t.items()))
                del xd, dyd, stats
            del x, dy
    # mean >> std at both widths: c = x - mean keeps S2's and dscale's precision
    for c in (1024, 2048):
        x = 1000.0 + 0.1 * torch.randn(8, 11, 11, c, device=dev, generator=gen)
        dy = torch.randn(8, 11, 11, c, device=dev, generator=gen)
        ones, zeros = torch.ones(c, device=dev), torch.zeros(c, device=dev)
        hold(f"mean>>std B=8 11x11x{c} G=32 float32", x, dy, gn_group_stats(x, 32), ones, zeros,
             True)
    log("a2j_group", f"K2r/K2d at C/G 32 and 64 (B={A2J_GROUP_BACKWARD_BATCHES}, f32 and bf16, "
        f"params f32 and x's type, ReLU on and off, mean>>std), {cases} cases: K2r sums max|err| "
        f"{worst['sums']:.3e}, dparams {worst['dparams']:.3e} of scale (tol 1e-5), two launches "
        "bit-equal; K2d bit-equal to its plain version on K2r's sums, two launches bit-equal")
    return {"err": worst_abs, "rows": rows}


def a2j_group_model(cfg):
    """The seeded GroupNorm A2J on the host: the convs from ``init_weights_``
    (seed ``SEED``), every norm's affine drawn from a generator of the same
    seed (scale 0.5-1.5, bias N(0, 0.1)); 65 GroupNorms."""
    import torch

    from handnet_tpu_torch.models.a2j import A2JSystem
    from handnet_tpu_torch.nn.resnet import GroupNorm

    model = A2JSystem(cfg, norm="group")
    model.init_weights_(torch.Generator().manual_seed(SEED))
    gen = torch.Generator().manual_seed(SEED)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, GroupNorm):
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
    norms = sum(isinstance(m, GroupNorm) for m in model.modules())
    if norms != A2J_GROUP_NORMS:
        raise AssertionError(f"A2JSystem(norm='group'): {norms} GroupNorms")
    return model


def grad_spread(got: dict, want: dict) -> tuple:
    """|g - g_want| / |g_want| per tensor: (median, worst tensor, its value)."""
    err = {n: ((got[n] - want[n]).norm() / want[n].norm().clamp(min=1e-30)).item()
           for n in want}
    worst = max(err, key=err.get)
    return sorted(err.values())[len(err) // 2], worst, err[worst]


def a2j_group_train(dev) -> dict:
    """A2J-GN's train step at full width: ``A2JTrainer.train_step`` (AdamW,
    autocast bf16 over float32 parameters with the loss outside it, or
    float32) on a ``TrainState`` of the GroupNorm A2J (the trainer itself
    builds the batch-norm one), batch ``A2J_GROUP_TRAIN_BATCH`` of seeded
    176^2 crops, in float32 (TF32 off) and bf16:

    * one step with the kernels and one through the plain versions
      (``use_kernels=False``) from the same seed: 65 launches each of K2s,
      K2a, K2r and K2d in the first and none of ours in the second (counted
      from 0 for each); the losses and every parameter's gradient within
      ``A2J_GROUP_STEP_TOL``;
    * ``A2J_GROUP_STEPS`` AdamW updates in all with the kernels, finite
      losses;
    * ms per step by CUDA events over ``A2J_GROUP_TIMED_STEPS`` steps (TF32
      on) and, in bf16, one step's kernels on the device (torch.profiler),
      beside the batch-norm A2J's (``A2JTrainer.init_state``) from the same
      seed and batch.

    Returns the launches per step of the kernel path."""
    import copy

    import torch

    from handnet_tpu_torch.config import A2JConfig, TrainConfig
    from handnet_tpu_torch.nn.resnet import GroupNorm
    from handnet_tpu_torch.ops.cuda_gn import group_norm
    from handnet_tpu_torch.train.trainer import A2JTrainer, TrainState, make_optimizer

    cfg = A2JConfig()
    batch = {k: v.to(dev) for k, v in a2j_train_batch(A2J_GROUP_TRAIN_BATCH, SEED, cfg.crop_h,
                                                      cfg.num_joints).items()}
    want = {**{name: 0 for name in counted_wrappers()},
            **{name: A2J_GROUP_NORMS for name in GN_TRAIN_KERNELS}}
    seeded = a2j_group_model(cfg).to(dev, memory_format=torch.channels_last)
    for bf16 in (False, True):
        kind = "bfloat16" if bf16 else "float32"
        tcfg = TrainConfig(batch_size=A2J_GROUP_TRAIN_BATCH, bf16=bf16)
        trainer = A2JTrainer(cfg, tcfg, device=dev)

        def fresh(on: bool, nudge: float = 0.0):
            model = copy.deepcopy(seeded)
            model.use_kernels = on
            with torch.no_grad():
                for m in model.modules():
                    if isinstance(m, GroupNorm):
                        m.weight.mul_(1 + nudge)
            return TrainState(0, model, make_optimizer(tcfg, model.parameters()),
                              trainer.schedule)

        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = bf16
        # the kernels, the plain path, and the plain path with every norm's
        # scale moved by A2J_GROUP_CONTROL (relative), about as far as the
        # kernels' statistics are from the plain ones: how far such last-bit
        # differences alone move a step
        runs, states = {}, {}
        for key, on, nudge in (("kernels", True, 0.0), ("plain", False, 0.0),
                               ("control", False, A2J_GROUP_CONTROL)):
            state = fresh(on, nudge)
            reset_launch_counts()
            before = group_norm.dy_copies
            state, metrics = trainer.train_step(state, batch)
            counts = launch_counts()
            if counts != (want if on else {k: 0 for k in want}):
                raise AssertionError(f"a2j_group train step {kind} kernels={on}: launches "
                                     f"{counts}, expected {want if on else 0}")
            runs[key] = ({k: v.item() for k, v in metrics.items()},
                         {n: p.grad.detach().float().clone()
                          for n, p in state.model.named_parameters()})
            if on:
                states["group"], copies = state, group_norm.dy_copies - before
            del state
        mk, mp = runs["kernels"][0], runs["plain"][0]
        tol = dict(A2J_GROUP_STEP_TOL[kind])
        loss_err = max(abs(mk[k] - mp[k]) / max(abs(mp[k]), 1e-12) for k in mp)
        spread = {key: grad_spread(runs[key][1], runs["plain"][1])
                  for key in ("kernels", "control")}
        (median, worst, worst_err), control = spread["kernels"], spread["control"]
        if "control" in tol:
            tol.update(grad_median=tol["control"] * control[0],
                       grad_max=tol["control"] * control[2])
        log("a2j_group", f"train step {kind} at batch {A2J_GROUP_TRAIN_BATCH} (TF32 "
            f"{'on' if bf16 else 'off'}), kernels vs plain: losses max rel err {loss_err:.3e} "
            f"(tol {tol['loss']:g}); gradients |g_k - g_p| / |g_p| per tensor over "
            f"{len(runs['plain'][1])}: median {median:.3e} (tol {tol['grad_median']:.3e}), max "
            f"{worst_err:.3e} ({worst}; tol {tol['grad_max']:.3e}); the control (every "
            f"norm's scale x (1 + {A2J_GROUP_CONTROL:g}), plain) against the plain step: "
            f"median {control[0]:.3e}, max {control[2]:.3e} ({control[1]}); launches per "
            f"step {want}, {copies} dy copies to NHWC")
        if (loss_err > tol["loss"] or median > tol["grad_median"]
                or worst_err > tol["grad_max"]):
            raise AssertionError(f"a2j_group train step {kind}: kernels vs plain outside "
                                 f"tolerance (loss {loss_err:.3e}, median {median:.3e}, "
                                 f"{worst} {worst_err:.3e})")
        del runs
        free_device_memory(dev)
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = False
        state = states.pop("group")
        totals = [mk["total_loss"]]
        for _ in range(A2J_GROUP_STEPS - 1):
            state, metrics = trainer.train_step(state, batch)
            totals.append(metrics["total_loss"].item())
        if not all(math.isfinite(v) for v in totals):
            raise AssertionError(f"a2j_group train {kind}: losses {totals}")
        ms = {"group": cuda_ms(lambda: trainer.train_step(state, batch),
                               iters=A2J_GROUP_TIMED_STEPS, warmup=1)}
        line = (f"A2J-GN {kind} at batch {A2J_GROUP_TRAIN_BATCH}: total loss by AdamW update "
                + ", ".join(f"{v:.4f}" for v in totals) + f" (finite); {ms['group']:.3f} ms "
                f"per step (CUDA events over {A2J_GROUP_TIMED_STEPS} steps, TF32 on)")
        if bf16:
            device = {"group": step_profile("a2j_group", "A2J-GN bf16 step",
                                            lambda: trainer.train_step(state, batch), top=5)}
            del state
            free_device_memory(dev)
            bn = trainer.init_state(SEED)
            ms["batch"] = cuda_ms(lambda: trainer.train_step(bn, batch),
                                  iters=A2J_GROUP_TIMED_STEPS, warmup=1)
            device["batch"] = step_profile("a2j_group", "batch-norm A2J bf16 step",
                                           lambda: trainer.train_step(bn, batch), top=5)
            line += (f", kernels {device['group']:.3f} ms on the device; the batch-norm A2J "
                     f"(A2JTrainer's model, same seed and batch) {ms['batch']:.3f} ms per step, "
                     f"kernels {device['batch']:.3f} ms on the device")
            del bn
        else:
            del state
        log("a2j_group", line)
        del trainer
        free_device_memory(dev)
    del seeded
    return want


def phase_a2j_group(dev) -> dict:
    """A2J with GroupNorm at full width: ``a2j_group_kernels`` (K2s, K2a),
    ``a2j_group_backward_kernels`` (K2r, K2d), the train step
    (``a2j_group_train``: 65 launches of each of the four per step), then
    ``A2JSystem(norm="group").predict`` (dilated ResNet-50, three 256-wide
    towers, 176^2 depth crops, 21 joints; seeded random convs and norm
    affines) at B = 64 and 128 in float32 and bf16 (autocast): 65 K2s + 65
    K2a + 1 K1 launches per call and nothing else, counted from 0 for each
    batch and dtype, two calls bit-equal; the kernel path against the plain
    path (``use_kernels=False``: the plain K2s, K2a and K1) within
    ``A2J_GROUP_TOL_F32`` px in float32 (TF32 off) and ``A2J_GROUP_TOL_BF16``
    in bf16; crops/s against the frozen-BN A2J at the same batch and dtype
    (``a2j_group_turns``). Returns the four kernels' rows, K2s's and K2r's
    largest errors, and the launches per predict call and per train step."""
    import torch

    from handnet_tpu_torch.config import A2JConfig
    from handnet_tpu_torch.models.a2j import A2JSystem

    kernels = a2j_group_kernels(dev)
    backward = a2j_group_backward_kernels(dev)
    per_step = a2j_group_train(dev)
    cfg = A2JConfig()
    model = a2j_group_model(cfg)
    frozen = A2JSystem(cfg)
    frozen.init_weights_(torch.Generator().manual_seed(SEED))
    model, frozen = (m.to(dev, memory_format=torch.channels_last).eval() for m in (model, frozen))
    crops = a2j_train_batch(max(A2J_GROUP_PREDICT), SEED, cfg.crop_h, cfg.num_joints)["image"]
    crops = crops.to(dev)
    want_per_call = {**{name: 0 for name in counted_wrappers()},
                     "gn_group_stats": A2J_GROUP_NORMS, "gn_apply": A2J_GROUP_NORMS,
                     "a2j_decode": 1}
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for b in A2J_GROUP_PREDICT:
            x = crops[:b]

            def predict(net=model, x=x, dtype=dtype):
                with torch.inference_mode(), torch.autocast(
                        "cuda", dtype=torch.bfloat16, enabled=dtype == torch.bfloat16):
                    return net.predict(x)

            reset_launch_counts()
            outs = [predict() for _ in range(A2J_GROUP_CALLS)]
            launches = launch_counts()
            if per_call(launches, A2J_GROUP_CALLS) != want_per_call or any(
                    v % A2J_GROUP_CALLS for v in launches.values()):
                raise AssertionError(f"a2j_group predict B={b} {dtype}: launches {launches} "
                                     f"over {A2J_GROUP_CALLS} calls, expected {want_per_call} "
                                     "per call")
            for out in outs:
                if tuple(out.shape) != (b, cfg.num_joints, 3) or not bool(
                        torch.isfinite(out).all()):
                    raise AssertionError(f"a2j_group predict B={b} {dtype}: UVD "
                                         f"{tuple(out.shape)}, finite "
                                         f"{bool(torch.isfinite(out).all())}")
            if not torch.equal(outs[0], outs[1]):
                raise AssertionError(f"a2j_group predict B={b} {dtype}: calls differ")
            # the plain path, TF32 off in float32 as the other float32 checks
            f32 = dtype == torch.float32
            if f32:
                torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
            model.use_kernels = False
            try:
                plain = predict()
                model.use_kernels = True
                got = predict()
            finally:
                model.use_kernels = True
                torch.backends.cudnn.allow_tf32 = True
                torch.backends.cuda.matmul.allow_tf32 = False
            tol = A2J_GROUP_TOL_F32 if f32 else A2J_GROUP_TOL_BF16
            errs[(b, dtype)] = check(f"a2j_group B={b} {dtype}: kernel vs plain path", got,
                                     plain, tol)
            log("a2j_group", f"A2JSystem(norm='group').predict B={b} {dtype}: UVD "
                f"{tuple(outs[0].shape)} finite, {A2J_GROUP_CALLS} calls bit-equal, launches "
                f"per call {per_call(launches, A2J_GROUP_CALLS)} (65 K2s + 65 K2a + 1 K1, "
                f"nothing else); kernel path == plain path within {errs[(b, dtype)]:.3e} px "
                f"(tol {tol:g}{', TF32 off' if f32 else ''})")
            a2j_group_turns(f"B={b} {dtype}", b, lambda net: predict(net), model, frozen)
            del outs, plain, got
    del model, frozen, crops
    free_device_memory(dev)
    return {"rows": {**kernels["rows"], **backward["rows"]},
            "err": {"gn_group_stats": kernels["err"], "gn_backward_sums": backward["err"]},
            "paths": {"a2j_group": want_per_call, "train_a2j_group": per_step}}


def a2j_group_turns(name: str, batch: int, predict, group, frozen) -> None:
    """Crops/s of the GroupNorm A2J against the frozen-BN A2J (CUDA events,
    TF32 on): ``A2J_GROUP_PAIRS`` pairs of turns of ``A2J_GROUP_TURN`` calls,
    the order alternating (group first in even pairs), after one warm-up
    call each. Prints each model's median turn and its spread, and names a
    model ahead only where the two spreads do not overlap."""
    import statistics

    ms = {"group": [], "frozen": []}
    nets = {"group": group, "frozen": frozen}
    for net in nets.values():
        predict(net)
    for i in range(A2J_GROUP_PAIRS):
        for key in ("group", "frozen") if i % 2 == 0 else ("frozen", "group"):
            ms[key].append(cuda_ms(lambda net=nets[key]: predict(net), iters=A2J_GROUP_TURN,
                                   warmup=0))
    rate = {key: {"median": batch / statistics.median(v) * 1e3,
                  "low": batch / max(v) * 1e3, "high": batch / min(v) * 1e3}
            for key, v in ms.items()}
    if min(ms["group"]) > max(ms["frozen"]):
        verdict = "frozen-BN ahead (the spreads do not overlap)"
    elif max(ms["group"]) < min(ms["frozen"]):
        verdict = "GroupNorm ahead (the spreads do not overlap)"
    else:
        verdict = "unresolved: the spreads overlap"
    log("a2j_group", f"crops/s {name} over {A2J_GROUP_PAIRS} pairs of turns of "
        f"{A2J_GROUP_TURN} calls (CUDA events, TF32 on): "
        + "; ".join(f"{'GroupNorm' if key == 'group' else 'frozen-BN'} median "
                    f"{r['median']:.1f}, turns {r['low']:.1f} to {r['high']:.1f} (median "
                    f"{statistics.median(ms[key]):.3f} ms a call)"
                    for key, r in rate.items())
        + f"; {verdict}")


E2E_ITEMS = 16                    # E2EDataSource items of [fcos_apps]' tree
E2E_BATCH = 8                     # the fast pipeline's calls on them, bf16
SEQ_CAMERAS = 8                   # DexYCB's 8 serials, one frame each
SEQ_FRAMES = 2
DEPROJECT_TOL = 1e-5              # m: float32 on the card against float64 numpy
OFFSET_TOL = 1e-5                 # the offset field, card against CPU (float32)
GRASP_SCENES = 2
GRASP_CANDIDATES = 100


def write_sequence_tree(root: str, seed: int) -> tuple:
    """A DexYCB sequence of ``SEQ_CAMERAS`` cameras x ``SEQ_FRAMES`` frames of
    480x640 16-bit depth PNGs (a tilted plane and a box in millimetres),
    their intrinsics (``<serial>_640x480.yml``), a ``meta.yml`` naming the
    extrinsics and ``extrinsics.yml`` (12 row-major numbers per camera);
    returns the sequence and the serials."""
    import os

    import numpy as np

    from handnet_tpu_torch.data import image_io
    from handnet_tpu_torch.data.dexycb import SERIALS

    rng = np.random.default_rng(seed)
    seq = "20200709-subject-01/20200709_141754"
    intr = os.path.join(root, "calibration", "intrinsics")
    extr = os.path.join(root, "calibration", "extrinsics_20200702_151821")
    os.makedirs(intr)
    os.makedirs(extr)
    yy, xx = np.mgrid[0:480, 0:640]
    rows = []
    for i, serial in enumerate(SERIALS[:SEQ_CAMERAS]):
        os.makedirs(os.path.join(root, seq, serial))
        for f in range(SEQ_FRAMES):
            depth = 900 + 0.4 * xx + 0.3 * yy + rng.normal(0, 3, size=xx.shape)
            depth[200:300, 250:380] -= 300
            depth[rng.uniform(size=xx.shape) < 0.05] = 0
            image_io.write_png(os.path.join(root, seq, serial,
                                            f"aligned_depth_to_color_{f:06d}.png"),
                               np.clip(depth, 0, 65535).astype(np.uint16))
        with open(os.path.join(intr, f"{serial}_640x480.yml"), "w") as fh:
            fh.write(f"color:\n  fx: {610.0 + 3 * i}\n  fy: {609.5 + 2 * i}\n  ppx: "
                     f"{320.5 - i}\n  ppy: {240.25 + i}\n")
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        m = np.concatenate([q * np.sign(np.linalg.det(q)), rng.normal(size=(3, 1))], axis=1)
        rows.append(f"  '{serial}': [{', '.join(repr(float(v)) for v in m.ravel())}]\n")
    with open(os.path.join(extr, "extrinsics.yml"), "w") as fh:
        fh.write("extrinsics:\n" + "".join(rows) + f"master: '{SERIALS[0]}'\n")
    with open(os.path.join(root, seq, "meta.yml"), "w") as fh:
        fh.write("serials:\n" + "".join(f"- '{s}'\n" for s in SERIALS[:SEQ_CAMERAS])
                 + f"extrinsics: '20200702_151821'\nnum_frames: {SEQ_FRAMES}\n")
    return seq, list(SERIALS[:SEQ_CAMERAS])


def e2e_coco(items, out, evaluator, voc) -> tuple:
    """COCO bbox and keypoints of the pipeline's found hands (its padded crop
    box, score and frame-UV joints) against each item's GT hand box and 2D
    joints, one image per item."""
    import numpy as np

    annotations, dets, gt_kpts, dt_kpts = {}, [], {}, {}
    for i, item in enumerate(items):
        gt = voc.GTObject("hand", item["hand_box"].astype(np.float64))
        annotations[str(i)] = [gt]
        gt_kpts[id(gt)] = np.concatenate([item["joints2d_abs"], np.ones((21, 1))], axis=1)
        if out is None:                            # the GT given back as detections
            det = voc.Detection(str(i), 1.0, gt.bbox)
            dt_kpts[id(det)] = item["joints2d_abs"].astype(np.float64)
        elif out["found"][i]:
            det = voc.Detection(str(i), float(out["scores"][i]),
                                np.asarray(out["boxes"][i], np.float64))
            dt_kpts[id(det)] = np.asarray(out["joints_uvd_full"][i, :, :2], np.float64)
        else:
            continue
        dets.append(det)
    ev = evaluator(annotations)
    labels = ["hand"] * len(dets)
    return (ev.evaluate(dets, labels),
            ev.evaluate(dets, labels, iou_type="keypoints", gt_keypoints=gt_kpts,
                        dt_keypoints=dt_kpts))


def host_evaluators(seed: int) -> None:
    """``BOPEvaluator`` with VSD at 480x640 and ``GraspEvaluator`` over
    ``GRASP_SCENES`` scenes of ``GRASP_CANDIDATES`` candidate grasps at the
    8 distance thresholds, each timed on the card's host."""
    import numpy as np

    from handnet_tpu_torch.eval.bop_pose import BOPEvaluator
    from handnet_tpu_torch.eval.grasp import GraspEvaluator, GraspScene
    from handnet_tpu_torch.utils.raster import render_depth

    rng = np.random.default_rng(seed)

    def rotation():
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        return q * np.sign(np.linalg.det(q))

    # a closed box mesh of 12 triangles, 80 x 60 x 40 mm, and its surface points
    corners = np.array([[x, y, z] for x in (-40, 40) for y in (-30, 30) for z in (-20, 20)], float)
    faces = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
                      [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]])
    half = np.array([40.0, 30.0, 20.0])
    pts = rng.uniform(-1, 1, size=(2000, 3)) * half
    axis = rng.integers(0, 3, 2000)
    pts[np.arange(2000), axis] = np.sign(rng.normal(size=2000)) * half[axis]
    k = np.array([[610.0, 0, 320], [0, 610.0, 240], [0, 0, 1]])
    gt, est, depth = [], [], {}
    for i in range(4):
        r, t = rotation(), np.array([0.0, 0.0, 600.0]) + rng.normal(size=3) * 20
        gt.append({"image_id": i, "obj_id": 1, "R": r, "t": t})
        est.append({"image_id": i, "obj_id": 1, "R": r if i % 2 else rotation(),
                    "t": t + rng.normal(size=3) * 5 * (i + 1)})
        d = render_depth(corners @ r.T + t, faces, k, 480, 640)
        depth[i] = np.where(d > 0, d + rng.normal(0, 2, size=d.shape), 0.0)
    ev = BOPEvaluator({1: pts}, {1: float(np.linalg.norm(2 * half))}, faces={1: faces},
                      mesh_verts={1: corners})
    start = time.perf_counter()
    res = ev.evaluate(est, gt, depth_images=depth, K=k)
    bop_s = time.perf_counter() - start
    if res["n_evaluated"] != 4 or not all(0.0 <= res[key] <= 1.0 for key in (
            "ar_vsd", "ar_mssd", "ar_mspd", "mean_ar", "add_s_recall_0.1d")):
        raise AssertionError(f"BOPEvaluator: {res}")
    log("e2e_eval", f"BOPEvaluator, 4 estimates with VSD at 480x640 (software z-buffer, a "
        f"12-triangle box): {bop_s * 1e3:.1f} ms on the host ({bop_s / 4 * 1e3:.1f} ms per "
        "estimate); " + ", ".join(f"{key} {res[key]:.4f}" for key in
                                  ("ar_vsd", "ar_mssd", "ar_mspd", "mean_ar")))

    box = rng.uniform(-1, 1, size=(300, 3)) * [0.04, 0.03, 0.02]
    scenes = []
    for _ in range(GRASP_SCENES):
        cands = []
        for _ in range(GRASP_CANDIDATES):
            g = np.eye(4)
            g[:3, :3] = rotation()
            g[:3, 3] = g[:3, :3] @ np.array([0, 0, -rng.uniform(0.09, 0.14)])
            cands.append(g)
        pose = np.eye(4)
        pose[:3, :3], pose[:3, 3] = rotation(), [0.0, 0.0, 0.6]
        pred = pose.copy()
        pred[:3, 3] += rng.normal(size=3) * 0.005
        hand = pose[:3, 3] + rng.normal(size=(100, 3)) * 0.03 + [0.0, 0.09, 0.0]
        scenes.append(GraspScene(candidate_grasps=np.stack(cands), obj_pose_gt=pose,
                                 obj_pc=box, obj_pose_pred=pred, hand_verts_gt=hand,
                                 hand_pc_pred=hand + rng.normal(size=hand.shape) * 0.004))
    grasp = GraspEvaluator()
    start = time.perf_counter()
    rows = grasp.evaluate_scenes(scenes)
    grasp_s = time.perf_counter() - start
    if len(rows) != 8 or not all(0.0 <= r[3] <= 1.0 and 0.0 <= r[4] <= 1.0 for r in rows):
        raise AssertionError(f"GraspEvaluator: rows {rows}")
    log("e2e_eval", f"GraspEvaluator, {GRASP_SCENES} scenes of {GRASP_CANDIDATES} candidate "
        f"grasps at the 8 distance thresholds: {grasp_s * 1e3:.1f} ms on the host "
        f"({grasp_s / GRASP_SCENES * 1e3:.1f} ms per scene); coverage by threshold "
        + ", ".join(f"{r[2]:.2f}: {r[3]:.3f}" for r in rows))


def phase_e2e_eval(dev, cfg_fast, trees: str) -> dict:
    """On ``[fcos_apps]``' synthetic tree (colour, 480x640): ``E2EDataSource``
    items with a synthetic ``ManoLayer`` on the card, the fast pipeline on
    them in bf16 batches of ``E2E_BATCH`` (K2s/K2a 24 and K1 1 per call), COCO
    bbox and keypoints of its hands (the GT given back: AP 1.0; the seed-2
    weights: finite, in [0, 1]); ``SequenceLoader`` over a tree of 8 cameras
    written here, ``deproject_depth`` on the card against float64 numpy; the
    offset field card against CPU; the BOP and grasp evaluators on the host.
    Returns the pipeline's launches per call."""
    import os
    import tempfile

    import numpy as np
    import torch

    from handnet_tpu_torch.data.dexycb import DexYCBDataset, refine_indices
    from handnet_tpu_torch.data.e2e_data import E2EDataSource
    from handnet_tpu_torch.data.sequence import deproject_depth, sequence_loader_from_meta
    from handnet_tpu_torch.eval import voc
    from handnet_tpu_torch.eval.coco_det import CocoDetEvaluator
    from handnet_tpu_torch.models.mano import ManoAssets, ManoLayer
    from handnet_tpu_torch.models.pipeline import HandNetPipeline
    from handnet_tpu_torch.ops.offset_field import joint2offset, offset2joint_softmax

    # 1. E2E samples, the mesh regenerated on the card
    ds = DexYCBDataset("s0", "train", data_dir=os.path.join(trees, "tree"))
    layer = ManoLayer(ManoAssets.synthetic(np.random.default_rng(SEED), side="right"),
                      flat_hand_mean=True, device=dev)
    source = E2EDataSource(ds, refine_indices(ds), mano_layers={"right": layer})
    start = time.perf_counter()
    items = [source[i] for i in range(E2E_ITEMS)]
    item_ms = (time.perf_counter() - start) * 1e3 / E2E_ITEMS
    for item in items:
        if (item["image"].shape != (480, 640, 3) or item["verts3d"].shape != (778, 3)
                or not np.isfinite(item["verts3d"]).all() or not item["target_valid"].any()):
            raise AssertionError(f"e2e item: image {item['image'].shape}, verts3d "
                                 f"{item.get('verts3d', np.zeros(0)).shape}")
    log("e2e_eval", f"E2EDataSource: {E2E_ITEMS} items of {len(source)} (480x640 colour JPEG "
        f"and depth PNG decoded on the host, the detection target, verts3d [778, 3] from a "
        f"synthetic ManoLayer on the card): {item_ms:.1f} ms per item on one host core")

    # 2. the fast pipeline on them, bf16 batches of E2E_BATCH
    pipe = HandNetPipeline(cfg_fast, dtype=torch.bfloat16, device=dev, seed=SEED)
    frames = [tuple(torch.from_numpy(np.stack([it[k] for it in items[i:i + E2E_BATCH]])).to(dev)
                    for k in ("image", "depth", "paras"))
              for i in range(0, E2E_ITEMS, E2E_BATCH)]
    pipe(*frames[0])
    torch.cuda.synchronize()
    reset_launch_counts()
    outs = [pipe(*f) for f in frames]
    torch.cuda.synchronize()
    launches = launch_counts()
    calls = len(frames)
    if launches != expected_launches(calls, GN_LAYERS_PER_CALL):
        raise AssertionError(f"e2e_eval pipeline: launches {launches} in {calls} calls")
    out = {k: torch.cat([o[k] for o in outs]).cpu().numpy() for k in outs[0]}
    if not all(np.isfinite(out[k]).all() for k in ("joints_uvd_full", "scores", "boxes")):
        raise AssertionError("e2e_eval pipeline: non-finite outputs")
    log("e2e_eval", f"fast pipeline bf16 on the items, {calls} calls of {E2E_BATCH}: "
        f"{int(out['found'].sum())}/{E2E_ITEMS} found, outputs finite; launches "
        f"{per_call(launches, calls)} per call")
    del pipe, outs, frames

    # 3. COCO bbox and keypoints
    start = time.perf_counter()
    bbox, kpts = e2e_coco(items, out, CocoDetEvaluator, voc)
    coco_ms = (time.perf_counter() - start) * 1e3
    gt_bbox, gt_kpts = e2e_coco(items, None, CocoDetEvaluator, voc)
    if gt_bbox["AP"] != 1.0 or gt_kpts["AP"] != 1.0:
        raise AssertionError(f"COCO on the GT given back: bbox {gt_bbox}, keypoints {gt_kpts}")
    if not all(0.0 <= r[k] <= 1.0 for r in (bbox, kpts) for k in ("AP", "AP50", "AR")):
        raise AssertionError(f"COCO of the pipeline's hands: bbox {bbox}, keypoints {kpts}")
    log("e2e_eval", f"CocoDetEvaluator: the GT boxes and joints given back score bbox AP "
        f"{gt_bbox['AP']:.1f}, keypoints AP {gt_kpts['AP']:.1f}; the seed-{SEED} weights' hands: "
        f"bbox AP {bbox['AP']:.4f} (AP50 {bbox['AP50']:.4f}), keypoints AP {kpts['AP']:.4f}, "
        f"both evaluations {coco_ms:.1f} ms on the host")
    del items, source, layer

    # 4. deprojection: SequenceLoader over 8 cameras, card vs float64 numpy
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as root:
        seq, serials = write_sequence_tree(root, SEED)
        loader = sequence_loader_from_meta(root, seq, serials, device=dev)
        start = time.perf_counter()
        depth = loader.depth_frames(0)
        read_ms = (time.perf_counter() - start) * 1e3
        pts, mask = loader.points(0)
        torch.cuda.synchronize()
        inv_k = loader.inv_k.double().cpu().numpy()
        c2w = loader.cam_to_world.double().cpu().numpy()
        depth_d = torch.from_numpy(depth).to(dev)
        dep = timed(lambda: deproject_depth(depth_d, loader.inv_k, loader.cam_to_world))
    ys, xs = np.meshgrid(np.arange(480), np.arange(640), indexing="ij")
    pix = np.stack([xs, ys, np.ones_like(xs)], -1).reshape(-1, 3).astype(np.float64)
    cam = np.einsum("cij,nj->cni", inv_k, pix) * depth.astype(np.float64).reshape(
        len(serials), -1, 1)
    world = np.einsum("cij,cnj->cni", c2w[:, :3, :3], cam) + c2w[:, None, :3, 3]
    err = check("deproject_depth card vs float64", pts.double().cpu(),
                torch.from_numpy(world), DEPROJECT_TOL)
    if not np.array_equal(mask.cpu().numpy(), depth.reshape(len(serials), -1) > 1e-3):
        raise AssertionError("deproject_depth: masks differ")
    log("e2e_eval", f"SequenceLoader, {len(serials)} cameras x 480x640 (meta.yml, "
        f"extrinsics.yml, 16-bit PNGs): deproject_depth on the card == float64 numpy within "
        f"{err:.3e} m (tol {DEPROJECT_TOL:g}), masks equal; {dep['ms']:.4f} ms on the device, "
        f"{dep['loop_ms']:.4f} ms loop; the host's PNG read {read_ms:.1f} ms per frame of "
        f"{len(serials)} cameras")

    # 5. the offset field, card against CPU
    gen = np.random.default_rng(SEED)
    jt = torch.from_numpy(gen.uniform(-0.6, 0.6, size=(8, 21, 3)).astype(np.float32))
    img = torch.from_numpy(gen.uniform(-0.5, 1.2, size=(8, 1, 176, 176)).astype(np.float32))
    field = joint2offset(jt.to(dev), img.to(dev), 0.8, 44)
    back = offset2joint_softmax(field, img.to(dev), 0.8)
    field_c = joint2offset(jt, img, 0.8, 44)
    err_f = check("joint2offset card vs CPU", field.cpu(), field_c, OFFSET_TOL)
    err_b = check("offset2joint_softmax card vs CPU", back.cpu(),
                  offset2joint_softmax(field_c, img, 0.8), OFFSET_TOL)
    log("e2e_eval", f"offset field B=8 J=21 F=44 from 176^2 depth: joint2offset card == CPU "
        f"within {err_f:.3e}, offset2joint_softmax within {err_b:.3e} (tol {OFFSET_TOL:g})")
    free_device_memory(dev)

    # 6. the host evaluators
    host_evaluators(SEED)
    return {"e2e_pipeline": per_call(launches, calls)}


# --- the learning gates: both tools trained to a PASS on the card ---

# synthetic_e2e_validation at the tools' default geometry (256x352
# detector input, 96^2 crops) with shorter runs of batch 8: every stage is
# bound by the host (the launching thread shares the GIL with the loader's
# threads), not by the card, so the geometry costs nothing and the samples
# drawn set the time; A2J's first learning-rate step is at step 1000.
# rcnn_convergence --with-fcos as the JAX package's shortened run (300 steps
# at 192x256), in a second process beside it (a GIL of its own)
LEARN_E2E_ARGS = ["--batch", "8", "--fcos-steps", "300", "--a2j-steps", "1200"]
LEARN_RCNN_ARGS = ["--with-fcos", "--steps", "300", "--image-h", "192", "--image-w", "256"]
LEARN_RCNN_TIMEOUT_S = 900        # the R-CNN process's join, after the e2e run
# the margins the budget is chosen to clear (the PASS bars: 0.8, 0.5, 60 mm, 0.5)
LEARN_MARGINS = {"found_share": 0.9, "iou": 0.6, "mpjpe_mm": 45.0, "ap50": 0.6}
LEARN_K1_TOL = 1e-4               # px: K1 against its plain decode on the same heads
LEARN_HANDOFF_TOL = 1e-2          # px: the f32 pipeline against the trainers' eval forwards
LEARN_K3_BATCH = 8                # held-out frames in the K3-vs-plain batch
DETECTOR_INT8_LAUNCHES = 65       # the detector's share of the 129 K3 launches per call


class LaunchTally:
    """Per path, the launches of every outermost call of the methods given
    (``{(class, method): path name, or a function of the instance giving
    it}``) and the number of those calls: each call's counts are read just
    before and just after it. A call made inside another counted one adds
    to the outer one's path only. ``close`` puts the methods back."""

    def __init__(self, methods: dict):
        self.calls, self.launches, self.depth, self.saved = {}, {}, 0, []
        for (cls, attr), path in methods.items():
            original = cls.__dict__[attr]
            self.saved.append((cls, attr, original))
            setattr(cls, attr, self._counted(original, path))

    def _counted(self, original, path):
        import functools

        @functools.wraps(original)
        def counted(obj, *args, **kwargs):
            if self.depth:
                return original(obj, *args, **kwargs)
            name = path(obj) if callable(path) else path
            before = launch_counts()
            self.depth += 1
            try:
                return original(obj, *args, **kwargs)
            finally:
                self.depth -= 1
                after = launch_counts()
                self.calls[name] = self.calls.get(name, 0) + 1
                total = self.launches.setdefault(name, {k: 0 for k in after})
                for k, v in after.items():
                    total[k] += v - before[k]
        return counted

    def close(self) -> None:
        for cls, attr, original in self.saved:
            setattr(cls, attr, original)

    def per_call(self) -> dict:
        """Each path's launches per call, which must be a whole number."""
        out = {}
        for name, launches in self.launches.items():
            calls = self.calls[name]
            if any(v % calls for v in launches.values()):
                raise AssertionError(f"{name}: {launches} over {calls} calls is not the "
                                     "same per call")
            out[name] = per_call(launches, calls)
        return out


def learn_tally(prefix: str) -> LaunchTally:
    """Counts the gates' paths: train steps by trainer, A2J's eval step,
    pipeline calls (float or int8) and calibration, the detectors'
    held-out calls."""
    from handnet_tpu_torch.models.faster_rcnn import FasterRCNNFPN
    from handnet_tpu_torch.models.fcos import FCOSSystem
    from handnet_tpu_torch.models.pipeline import HandNetPipeline
    from handnet_tpu_torch.train.trainer import A2JTrainer, FCOSTrainer, RCNNTrainer

    fcos_step = "learn_train_fcos" if prefix == "e2e" else "learn_train_fcos_control"
    return LaunchTally({
        (FCOSTrainer, "train_step"): fcos_step,
        (RCNNTrainer, "train_step"): "learn_train_rcnn",
        (A2JTrainer, "train_step"): "learn_train_a2j",
        (A2JTrainer, "eval_step"): "learn_eval_a2j",
        (HandNetPipeline, "forward"): lambda pipe: ("learn_pipeline_int8" if pipe.cfg.fcos.quant
                                                    else "learn_pipeline"),
        (HandNetPipeline, "calibrate"): "learn_calibrate",
        (FCOSSystem, "detect"): "learn_detect_fcos",
        (FasterRCNNFPN, "forward"): "learn_detect_rcnn",
    })


def learn_run(tag: str, main, argv: list, device_arg: str = "cuda",
              tally_for=None) -> tuple:
    """``main(argv + ["--device", device_arg], report)`` under a launch
    tally (``tally_for(tag)``, :func:`learn_tally` by default). Raises
    unless it exits 0 (PASS) and every launch of the run belongs to a
    counted call. Returns ``(report, launches per call by path, calls by
    path, seconds)``."""
    import torch

    report = {}
    reset_launch_counts()
    tally = (tally_for or learn_tally)(tag)
    start = time.perf_counter()
    try:
        code = main(argv + ["--device", device_arg], report)
    finally:
        tally.close()
    if torch.device(device_arg).type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = launch_counts()
    counted = {k: sum(t[k] for t in tally.launches.values()) for k in launches}
    if code != 0:
        raise AssertionError(f"{tag} exited {code} (FAIL)")
    if counted != launches:
        raise AssertionError(f"{tag}: {launches} launched, {counted} inside the "
                             "counted calls")
    return report, tally.per_call(), dict(tally.calls), seconds


def learn_rcnn_process(_rank: int, out_file: str, argv: list, device_arg: str) -> None:
    """``rcnn_convergence`` through :func:`learn_run` in a process of its
    own (spawned by :func:`phase_learn`), its output in ``out_file``.log;
    saves each net's record and stats and the launches and calls by path."""
    import contextlib

    import torch

    from handnet_tpu_torch.tools import rcnn_convergence

    with open(out_file + ".log", "w") as out, contextlib.redirect_stdout(out):
        report, per_call_rc, calls, seconds = learn_run("rcnn", rcnn_convergence.main, argv,
                                                        device_arg)
    torch.save({"nets": {net: {"record": e["record"], "stats": e["stats"]}
                         for net, e in report["nets"].items()},
                "per_call": per_call_rc, "calls": calls, "seconds": seconds}, out_file)


def nonzero(paths: dict) -> dict:
    """Each path's launches per call without the kernels it does not launch."""
    return {name: {k: v for k, v in counts.items() if v} for name, counts in paths.items()}


def learn_expected(name: str) -> dict:
    """The launches per call of each path of the gates and the studies."""
    zero = {k: 0 for k in counted_wrappers()}
    gn, gn_train = {"gn_group_stats": 24, "gn_apply": 24}, dict.fromkeys(GN_TRAIN_KERNELS, 24)

    def k3(n: int) -> dict:
        return dict.fromkeys(("int8_quantize", "int8_conv_gemm"), n)

    pipeline = {**gn, "a2j_decode": 1}
    pipeline_int8 = {**pipeline, **k3(INT8_LAUNCHES_PER_CALL)}
    # one calibration batch: the detector alone, then detector and A2J
    calibrate = {"gn_group_stats": 48, "gn_apply": 48,
                 **k3(DETECTOR_INT8_LAUNCHES + INT8_LAUNCHES_PER_CALL)}
    # an int8 detect, or the detector alone calibrating (its dynamic path)
    detect_int8 = {**gn, **k3(DETECTOR_INT8_LAUNCHES)}
    return {**zero, **{
        "learn_train_fcos": gn_train, "learn_train_fcos_control": gn_train,
        "learn_train_a2j": {}, "learn_train_rcnn": {}, "learn_detect_rcnn": {},
        "learn_eval_a2j": {"a2j_decode": 1}, "learn_detect_fcos": gn,
        "learn_pipeline": pipeline, "learn_pipeline_int8": pipeline_int8,
        "learn_calibrate": calibrate,
        "study_train_fcos": gn_train, "study_detect": gn, "study_detect_int8": detect_int8,
        "study_calibrate_detector": detect_int8, "study_pipeline": pipeline,
        "study_pipeline_int8": pipeline_int8, "study_calibrate": calibrate,
    }[name]}


def check_learn_paths(tool: str, per_call_run: dict, calls: dict, want_calls: dict) -> None:
    """A tool's calls by path and launches per call against the expected."""
    if calls != want_calls:
        raise AssertionError(f"{tool}'s calls {calls}, expected {want_calls}")
    for name, got in per_call_run.items():
        if got != learn_expected(name):
            raise AssertionError(f"{tool}: {name}: {got} per call, expected "
                                 f"{learn_expected(name)}")


def log_stage(tag: str, stats: dict, batch: int, phase: str = "learn") -> None:
    log(phase, f"{tag}: loss {stats['first_loss']:.4f} -> {stats['last_loss']:.4f} over "
        f"{stats['steps']} steps of batch {batch}, {stats['seconds']:.1f} s, "
        f"{stats['steps_per_s']:.2f} steps/s, {100 * stats['loader_wait_share']:.1f}% of it "
        "waiting on the loader")


def learn_kernel_checks(dev, report: dict) -> None:
    """On the trained e2e stages: K1 against its plain decode on the same
    heads (the trained A2J's on the int8 pipeline's crops of held-out
    frames); K3 (K3q + K3g) against its plain version bit for bit in the
    calibrated int8 pipeline on a batch of held-out frames; the float32
    pipeline assembled from the trained models (TF32 off) against the
    trainers' eval forwards (``gates.handoff_errors``)."""
    import numpy as np
    import torch

    from handnet_tpu_torch.config import TrainConfig
    from handnet_tpu_torch.ops.cuda_a2j import a2j_decode, a2j_decode_reference
    from handnet_tpu_torch.tools import gates
    from handnet_tpu_torch.train.trainer import A2JTrainer

    (fcfg, _, fstate), (acfg, _, astate) = report["fcos"], report["a2j"]
    frames = report["frames"][:LEARN_K3_BATCH]
    images = gates.frames_01(np.stack([f[0] for f in frames]), dev)
    depth = torch.from_numpy(np.stack([f[1] for f in frames])).to(dev)
    label = f"{len(frames)} held-out frames at {fcfg.image_h}x{fcfg.image_w}, crop {acfg.crop_h}"

    pipe_q = report["pipeline_int8"]
    got = k3_bit_equal("learn: the calibrated int8 pipeline", pipe_q,
                       lambda: pipe_q(images, depth))
    log("learn", f"the calibrated static-int8 pipeline on {label}: every output bit-equal with "
        f"K3's plain version in place of K3 ({int(got['found'].sum())} found)")

    model = astate.model.eval()
    with torch.no_grad(), torch.autocast(dev.type, dtype=torch.bfloat16):
        heads = model(got["crops"])
    args = (heads["cls"], heads["reg"], heads["depth"], model.anchors)
    k1 = check("K1 on the trained A2J's heads", a2j_decode(*args),
               a2j_decode_reference(*args), LEARN_K1_TOL)
    log("learn", f"K1 vs its plain decode on the trained A2J's bf16 heads of the int8 "
        f"pipeline's crops of {label} (N = {heads['cls'].shape[1]}): max|err| {k1:.2e} px "
        f"(tol {LEARN_K1_TOL:g})")

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        pipe32 = gates.assemble_pipeline(gates.pipeline_config(fcfg, acfg, acfg.crop_h),
                                         fstate.model, astate.model, dtype=torch.float32,
                                         device=dev)
        plain_trainer = A2JTrainer(acfg, TrainConfig(bf16=False), device=dev)
        err = gates.handoff_errors(pipe32, fstate.model, plain_trainer, astate, images, depth)
    finally:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
    if not (err["found"] and max(err["box"], err["joints"]) <= LEARN_HANDOFF_TOL):
        raise AssertionError(f"learn: the assembled pipeline against the trainers' eval "
                             f"forwards: {err}")
    log("learn", f"handoff (f32, TF32 off): the pipeline assembled from the trained states "
        f"against FCOSSystem.detect of the trained detector ({err['detections']} detections: "
        f"boxes max|err| {err['box']:.2e} px, scores {err['score']:.2e}) and "
        f"A2JTrainer.eval_step on its own crops ({err['found']} found: joints max|err| "
        f"{err['joints']:.2e}); tol {LEARN_HANDOFF_TOL:g} px")


def learn_e2e(dev, smi: str, device_arg: str) -> dict:
    """``synthetic_e2e_validation`` at ``LEARN_E2E_ARGS``: PASS, its calls
    and launches, its stages, the margins, then the kernel checks on its
    trained stages. Returns its launches per call and held-out count. Its
    trained stages stay in ``STUDY_PACK`` for the saturation study."""
    import os

    from handnet_tpu_torch.tools import synthetic_e2e_validation

    os.makedirs(os.path.dirname(STUDY_PACK), exist_ok=True)
    e2e, per_call_e2e, calls, seconds = learn_run(
        "e2e", synthetic_e2e_validation.main, LEARN_E2E_ARGS + ["--save-state", STUDY_PACK],
        device_arg)
    args = synthetic_e2e_validation.parse_args(LEARN_E2E_ARGS)
    n = e2e["held_out"]
    check_learn_paths("synthetic_e2e_validation", per_call_e2e, calls, {
        "learn_train_fcos": args.fcos_steps, "learn_train_a2j": args.a2j_steps,
        "learn_eval_a2j": n, "learn_calibrate": 1, "learn_pipeline": n,
        "learn_pipeline_int8": n})
    log_stage("synthetic_e2e_validation stage 1 (FCOS, K2s/K2a/K2r/K2d 24 per step)",
              e2e["stats"]["fcos"], args.batch)
    log_stage("synthetic_e2e_validation stage 2 (A2J, no launch of ours per step)",
              e2e["stats"]["a2j"], args.batch)
    margins = {"found": e2e["found"] >= LEARN_MARGINS["found_share"] * n,
               "iou": e2e["iou"] >= LEARN_MARGINS["iou"],
               "mpjpe": e2e["mpjpe_mm"] <= LEARN_MARGINS["mpjpe_mm"],
               "found_int8": e2e["found_int8"] >= LEARN_MARGINS["found_share"] * n,
               "mpjpe_int8": e2e["mpjpe_int8_mm"] <= LEARN_MARGINS["mpjpe_mm"]}
    log("learn", f"synthetic_e2e_validation ({' '.join(LEARN_E2E_ARGS)}): VALIDATION: PASS in "
        f"{seconds:.1f} s; held out {n}: found {e2e['found']}/{n}, IoU {e2e['iou']:.4f}, "
        f"MPJPE {e2e['mpjpe_mm']:.2f} mm; static int8 found {e2e['found_int8']}/{n}, MPJPE "
        f"{e2e['mpjpe_int8_mm']:.2f} mm; A2J alone on its seg crops "
        f"{e2e['a2j_only']['mpjpe_mm']:.2f} mm (depth |err| "
        f"{e2e['a2j_only']['depth_err_mm']:.2f} mm); margins (found >= 90%, IoU >= 0.6, "
        f"MPJPE <= 45 mm) " + ("held" if all(margins.values()) else
                                f"NOT held: {[k for k, v in margins.items() if not v]}")
        + f"; launches per call {nonzero(per_call_e2e)}; {smi}")
    learn_kernel_checks(dev, e2e)
    return {"paths": per_call_e2e, "held_out": n}


def phase_learn(dev, smi: str, device_arg: str = "cuda") -> dict:
    """Both learning gates through ``main(argv)`` with ``--device cuda``,
    each on a synthetic tree of its own: ``rcnn_convergence`` at
    ``LEARN_RCNN_ARGS`` (with the FCOS control) in a spawned process,
    beside ``synthetic_e2e_validation`` at ``LEARN_E2E_ARGS`` (static int8)
    in this one. Each must PASS; each path's calls and launches per call
    must be the expected ones, and every launch of a run must fall in a
    counted call. Prints each stage's loss, seconds, steps/s and loader-wait
    share, the held-out numbers, whether the margins held, the kernel
    checks on the trained e2e stages and the R-CNN process's output.
    Returns the launches per call by path."""
    import os
    import tempfile

    import numpy as np
    import torch
    import torch.multiprocessing as mp

    from handnet_tpu_torch.tools import gates, rcnn_convergence

    with tempfile.TemporaryDirectory() as work:
        out_file = os.path.join(work, "rcnn.pt")
        start = time.perf_counter()
        ctx = mp.start_processes(learn_rcnn_process,
                                 args=(out_file, LEARN_RCNN_ARGS, device_arg), nprocs=1,
                                 join=False, start_method="spawn")
        try:
            e2e = learn_e2e(dev, smi, device_arg)
            deadline = time.monotonic() + LEARN_RCNN_TIMEOUT_S
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise AssertionError("learn: the rcnn_convergence process did not finish "
                                         "in time")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        both = time.perf_counter() - start
        with open(out_file + ".log") as out:
            print(out.read(), end="", flush=True)
        rc = torch.load(out_file, weights_only=False)
    free_device_memory(dev)

    n = e2e["held_out"]
    rargs = rcnn_convergence.parse_args(LEARN_RCNN_ARGS)
    check_learn_paths("rcnn_convergence", rc["per_call"], rc["calls"], {
        "learn_train_rcnn": rargs.steps, "learn_train_fcos_control": rargs.steps,
        "learn_detect_rcnn": n, "learn_detect_fcos": n})
    for net in ("rcnn", "fcos"):
        entry = rc["nets"][net]
        log_stage(f"rcnn_convergence {net}", entry["stats"], rargs.batch)
        rec = entry["record"]
        if not all(np.isfinite(v) for k, v in rec.items() if k != "net"):
            raise AssertionError(f"learn: {net}: {rec}")
        log("learn", f"rcnn_convergence {net} on {n} held-out frames: found rate "
            f"{rec['found_rate']:.4f}, mean IoU {rec['mean_iou']:.4f}, AP {rec['AP']:.4f}, "
            f"AP50 {rec['AP50']:.4f}, AP75 {rec['AP75']:.4f}, final loss {rec['final_loss']:.4f}")
    rcnn = rc["nets"]["rcnn"]["record"]
    held = (rcnn["found_rate"] >= LEARN_MARGINS["found_share"]
            and rcnn["AP50"] >= LEARN_MARGINS["ap50"])
    log("learn", f"rcnn_convergence ({' '.join(LEARN_RCNN_ARGS)}): RCNN CONVERGENCE: PASS in "
        f"{rc['seconds']:.1f} s in its own process, beside synthetic_e2e_validation (both "
        f"{both:.1f} s with the spawn); margins (found >= 0.9, AP50 >= 0.6) "
        f"{'held' if held else 'NOT held'}; launches per call {nonzero(rc['per_call'])}; "
        f"score threshold {gates.SCORE_THRESH}; {smi}")
    return {**e2e["paths"], **rc["per_call"]}


# --- the studies: the detector at the serving geometries, static int8 overexposed ---

# resolution_study at full width, 150 steps of batch 8 per spec: fast's and
# parity's detector inputs and quant_static's point. Its steps are bound by
# the host, as learn's are, so it trains in a process of its own (a GIL of
# its own) started beside learn; run after learn, the script would overrun
# its time limit. Beside learn it takes host time from learn's own stages,
# which set the phase's length: 300 steps a spec made the phase 280-362 s
# on an H100 host, so the depth is cut to half
STUDY_RES_ARGS = ["--resolutions", "512x640", "800x1088", "480x640@qs", "--steps", "150",
                  "--batch", "8"]
STUDY_RES_TIMEOUT_S = 600         # the resolution process's join, after the saturation study
STUDY_PACK = "build/studies/learn_states.msgpack"   # learn's trained stages
STUDY_HOT_GAIN = 2.0              # the saturating frames of the K3 checks
STUDY_K3_BATCH = 8


def study_tally(_tag: str) -> LaunchTally:
    """Counts the studies' paths: FCOS train steps, held-out detects (float
    or int8), the detector's calibration, pipeline calls (float or int8)
    and pipeline calibration."""
    from handnet_tpu_torch.models.fcos import FCOSSystem
    from handnet_tpu_torch.models.pipeline import HandNetPipeline
    from handnet_tpu_torch.tools import resolution_study
    from handnet_tpu_torch.train.trainer import FCOSTrainer

    return LaunchTally({
        (FCOSTrainer, "train_step"): "study_train_fcos",
        (FCOSSystem, "detect"): lambda m: "study_detect_int8" if m.cfg.quant else "study_detect",
        (resolution_study, "calibrate_detector"): "study_calibrate_detector",
        (HandNetPipeline, "forward"): lambda pipe: ("study_pipeline_int8" if pipe.cfg.fcos.quant
                                                    else "study_pipeline"),
        (HandNetPipeline, "calibrate"): "study_calibrate",
    })


def study_resolution_process(_rank: int, out_file: str, argv: list, device_arg: str) -> None:
    """``resolution_study`` through :func:`learn_run` in a process of its
    own, its output in ``out_file``.log; saves the records, each spec's
    training stats, the held-out count, the launches and calls by path and
    the calibrated static-int8 (``@qs``) detector's config and state."""
    import contextlib

    import torch

    from handnet_tpu_torch.tools import resolution_study

    with open(out_file + ".log", "w") as out, contextlib.redirect_stdout(out):
        report, per_call_rs, calls, seconds = learn_run(
            "resolution_study", resolution_study.main, argv, device_arg, study_tally)
    specs = resolution_study.parse_args(argv).resolutions
    qs = next(report[spec]["system"] for spec in specs
              if resolution_study.parse_spec(spec)[3] == "static")
    torch.save({"study": report["study"], "held_out": report["held_out"],
                "stats": {spec: report[spec]["stats"] for spec in specs},
                "qs_cfg": qs.cfg, "qs_state": {k: v.cpu() for k, v in qs.state_dict().items()},
                "per_call": per_call_rs, "calls": calls, "seconds": seconds}, out_file)


def start_resolution_study(work: str, device_arg: str = "cuda") -> tuple:
    """Spawns :func:`study_resolution_process` at ``STUDY_RES_ARGS``;
    returns ``(context, result file, start time)``."""
    import os

    import torch.multiprocessing as mp

    out_file = os.path.join(work, "resolution.pt")
    ctx = mp.start_processes(study_resolution_process,
                             args=(out_file, STUDY_RES_ARGS, device_arg), nprocs=1,
                             join=False, start_method="spawn")
    return ctx, out_file, time.perf_counter()


def stop_processes(ctx) -> None:
    for p in ctx.processes:
        if p.is_alive():
            p.kill()
            p.join()


def studies_saturation(dev, smi: str, device_arg: str) -> tuple:
    """``int8_saturation_study`` on learn's pack: its calls and launches,
    the rows, then K3 against its plain version in the margin-0 int8
    pipeline on 8 held-out frames at ``STUDY_HOT_GAIN``. Returns its
    launches per call by path and those frames (colours, depth, intrinsics)."""
    import numpy as np
    import torch

    from handnet_tpu_torch.tools import int8_saturation_study as sat

    argv = ["--state", STUDY_PACK]
    report, per_call_sat, calls, seconds = learn_run(
        "int8_saturation_study", sat.main, argv, device_arg, study_tally)
    args = sat.parse_args(argv)
    gains, margins = (len(v.split(",")) for v in (args.gains, args.margins))
    check_learn_paths("int8_saturation_study", per_call_sat, calls, {
        "study_pipeline": gains, "study_pipeline_int8": gains * margins,
        "study_calibrate": 1 + gains})
    for r in report["rows"]:
        log("studies", f"saturation gain {r['gain']}, margin {r['margin']}: overflow factor "
            f"{r['overflow_factor']}, found fp {r['fp_found']} / int8 {r['int8_found']}, "
            f"MPJPE fp {r['fp_mpjpe_mm']} / int8 {r['int8_mpjpe_mm']} mm, delta "
            f"{r['delta_mpjpe_mm']:+} mm")
    for r in report["paired"]:
        log("studies", f"saturation paired at gain {r['gain']}: {r['paired']}: "
            f"{r['n_frames']} frames, delta {r['delta_mpjpe_mean_mm']} mm, sem "
            f"{r['delta_mpjpe_sem_mm']} mm")
    for g, layer in report["overflow_layer"].items():
        log("studies", f"saturation gain {g}: the overflow factor's layer {layer}")
    colors, depths, paras, _ = report["frames"]
    log("studies", f"int8_saturation_study ({' '.join(argv)}) in {seconds:.1f} s: "
        f"{len(colors)} held-out frames, {gains} gains x {margins} margins; launches per call "
        f"{nonzero(per_call_sat)}; {smi}")

    pipe_q = report["pipeline_int8"]
    sat.restore_amaxes(pipe_q, report["raw"])
    hot = tuple(torch.from_numpy(np.ascontiguousarray(a[:STUDY_K3_BATCH])).to(dev)
                for a in (colors * STUDY_HOT_GAIN, depths, paras))
    found = int(k3_bit_equal("studies: the margin-0 static-int8 pipeline", pipe_q,
                             lambda: pipe_q(*hot))["found"].sum())
    log("studies", f"the margin-0 static-int8 pipeline (bf16) on {STUDY_K3_BATCH} held-out "
        f"frames at gain {STUDY_HOT_GAIN}: every output bit-equal with K3's plain version in "
        f"place of K3 ({found} found)")
    return per_call_sat, hot


def studies_resolution(dev, smi: str, resolution: tuple, hot: tuple) -> dict:
    """Joins the resolution process: its output, its calls and launches,
    each spec's record and stats; then K3 against its plain version in the
    calibrated ``@qs`` detector on the saturating frames ``hot``. Returns
    its launches per call by path."""
    import torch

    from handnet_tpu_torch.nn.quant import assert_calibrated
    from handnet_tpu_torch.tools import resolution_study

    ctx, out_file, start = resolution
    deadline = time.monotonic() + STUDY_RES_TIMEOUT_S
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            raise AssertionError("studies: the resolution_study process did not finish in time")
    with open(out_file + ".log") as out:
        print(out.read(), end="", flush=True)
    res = torch.load(out_file, weights_only=False)
    args = resolution_study.parse_args(STUDY_RES_ARGS)
    n = res["held_out"]
    quant = [resolution_study.parse_spec(spec)[3] for spec in args.resolutions]
    check_learn_paths("resolution_study", res["per_call"], res["calls"], {
        "study_train_fcos": args.steps * len(quant),
        "study_detect": n * sum(not q for q in quant), "study_detect_int8": n * sum(map(bool, quant)),
        "study_calibrate_detector": quant.count("static")})
    for spec, rec in zip(args.resolutions, res["study"]):
        stats = res["stats"][spec]
        log_stage(f"resolution_study {rec['resolution']}", stats, args.batch, "studies")
        log("studies", f"resolution_study {rec['resolution']} on {n} held-out frames: found rate "
            f"{rec['found_rate']:.4f}, mean IoU {rec['mean_iou']:.4f}, AP {rec['AP']:.4f}, AP50 "
            f"{rec['AP50']:.4f}, AP75 {rec['AP75']:.4f}, final loss {rec['final_loss']:.4f}; "
            f"{smi}")
    log("studies", f"resolution_study ({' '.join(STUDY_RES_ARGS)}) in {res['seconds']:.1f} s in "
        f"its own process ({time.perf_counter() - start:.1f} s since its spawn, beside learn); "
        f"launches per call {nonzero(res['per_call'])}")

    system = resolution_study.eval_system(res["qs_cfg"], res["qs_state"], "static",
                                          res["qs_cfg"].score_thresh, dev)
    assert_calibrated(system)
    with torch.inference_mode():
        k3_bit_equal("studies: the trained static-int8 detector", system,
                     lambda: system.detect(hot[0]))
    cfg = res["qs_cfg"]
    log("studies", f"the trained, calibrated {cfg.image_h}x{cfg.image_w}@qs detector (f32) on "
        f"the same {len(hot[0])} frames at gain {STUDY_HOT_GAIN}: every detection bit-equal "
        "with K3's plain version in place of K3")
    return res["per_call"]


def phase_studies(dev, smi: str, resolution: tuple, device_arg: str = "cuda") -> dict:
    """The saturation study on learn's pack, then the resolution study's
    process joined (``resolution`` from :func:`start_resolution_study`);
    both K3 checks on the saturating frames. Returns the launches per call
    by path; removes the pack."""
    import os

    try:
        per_call_sat, hot = studies_saturation(dev, smi, device_arg)
        per_call_res = studies_resolution(dev, smi, resolution, hot)
    finally:
        if os.path.exists(STUDY_PACK):
            os.remove(STUDY_PACK)
    return {**per_call_res, **per_call_sat}


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
    train = phase_train(dev, load_config().fcos)
    by_path["train_fcos"] = train["per_step"]
    results.update(train["results"])
    log("train", f"device memory after the phase: {torch.cuda.memory_allocated() / 2**30:.2f} "
        f"GiB allocated")
    lap("train")
    # data parallel: train_fcos under torchrun, two ranks, the mesh server
    by_path.update(phase_ddp(dev, cfg, smi))
    free_device_memory(dev)
    lap("ddp")
    # apps/train_a2j.py's recipe, then the Pose2Mesh app at its defaults
    by_path.update(phase_train_a2j(dev))
    lap("train_a2j")
    # the 2D A2J: K1xy, predict, training and the eval step
    a2j_2d = phase_a2j_2d(dev)
    results["a2j_decode_xy"] = a2j_2d["result"]
    by_path.update(a2j_2d["paths"])
    lap("a2j_2d")
    # A2J with GroupNorm: K2s/K2a at C/G 32 and 64, predict at full width
    a2j_group = phase_a2j_group(dev)
    for name, rows in a2j_group["rows"].items():
        results[name]["a2j_group_shapes"] = rows
    for name, err in a2j_group["err"].items():
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
    by_path.update(a2j_group["paths"])
    lap("a2j_group")
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
        # E2E samples, the pipeline and COCO, deprojection, offset field, BOP, grasps
        by_path.update(phase_e2e_eval(dev, cfg, trees))
        lap("e2e_eval")
    # the learning gates, each on a synthetic tree of its own: both stages
    # trained to a PASS, the pipeline assembled from them, float and int8;
    # the Faster R-CNN beside its FCOS control; and the resolution study's
    # process beside them. Then the studies: the saturation study on the
    # gate's trained stages, the resolution study joined
    with tempfile.TemporaryDirectory() as work:
        resolution = start_resolution_study(work)
        try:
            by_path.update(phase_learn(dev, smi))
            free_device_memory(dev)
            lap("learn")
            by_path.update(phase_studies(dev, smi, resolution))
        finally:
            stop_processes(resolution[0])
    free_device_memory(dev)
    lap("studies")
    phase_idle_shares(dev, cfg)
    lap("throughput")

    sources = {"a2j_decode": ("handnet_tpu_torch/csrc/a2j_decode.cu",
                              "handnet_tpu/ops/pallas_a2j.py:55"),
               # K1 without depth (kDepth false): the 2D A2J's decode, which
               # the JAX package leaves to the einsum (models/a2j.py:145-153)
               "a2j_decode_xy": ("handnet_tpu_torch/csrc/a2j_decode.cu",
                                 "handnet_tpu/ops/pallas_a2j.py:55"),
               "gn_group_stats": ("handnet_tpu_torch/csrc/gn_stats.cu",
                                  "handnet_tpu/ops/pallas_gn.py:138"),
               "gn_apply": ("handnet_tpu_torch/csrc/gn_apply.cu",
                            "handnet_tpu/ops/pallas_gn.py:167"),
               # the GroupNorm backward (K2r, K2d): no Pallas kernel had a
               # backward (pallas_gn is inference-only); they replace the
               # gradient that XLA derives for the towers' flax GroupNorm
               "gn_backward_sums": ("handnet_tpu_torch/csrc/gn_backward_sums.cu",
                                    "handnet_tpu/models/fcos.py:62"),
               "gn_backward_dx": ("handnet_tpu_torch/csrc/gn_backward_dx.cu",
                                  "handnet_tpu/models/fcos.py:62"),
               "int8_quantize": ("handnet_tpu_torch/csrc/int8_quantize.cu",
                                 "handnet_tpu/nn/quant.py:135"),
               "int8_conv_gemm": ("handnet_tpu_torch/csrc/int8_conv.cu",
                                  "handnet_tpu/nn/quant.py:139")}
    # launches: the quant_static run's (4 calls), K1xy's the 2D predict
    # run's, K2r's and K2d's the 20-step learning run's of [train] (their
    # main path); launches_per_call: each path's, counted from 0 just before
    # it and read just after
    launches["a2j_decode_xy"] = a2j_2d["launches"]
    for name in ("gn_backward_sums", "gn_backward_dx"):
        launches[name] = train["launches"][name]
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
