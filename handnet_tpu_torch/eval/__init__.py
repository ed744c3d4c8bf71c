"""Evaluators of the port: ``hpe`` (DexYCB hand-pose MPJPE/AUC). Import
submodules directly; nothing is loaded here."""
