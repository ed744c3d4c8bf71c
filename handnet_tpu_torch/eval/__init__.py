"""Evaluators of the port: ``hpe`` (DexYCB hand-pose MPJPE/AUC) and ``voc``
(100DOH detection AP, hand-constrained AP). Import
submodules directly; nothing is loaded here."""
