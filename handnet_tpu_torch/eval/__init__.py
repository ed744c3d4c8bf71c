"""Evaluators of the port, host numpy: ``hpe`` (DexYCB hand-pose MPJPE/AUC),
``voc`` (100DOH detection AP, hand-constrained AP), ``coco_det`` (COCO bbox,
segm and keypoints AP), ``bop_pose`` (6D pose errors, VSD through
``utils/raster.py``, BOP average recall) and ``grasp`` (grasp coverage and
precision over a distance sweep). Import submodules directly; nothing is
loaded here."""
