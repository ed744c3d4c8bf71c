"""The port's learning gates: ``synthetic_e2e_validation`` (both stages
trained from scratch, then the assembled pipeline, float and int8) and
``rcnn_convergence`` (the Faster R-CNN beside an FCOS control), with the
pieces they share in ``gates``; and the studies built on them:
``resolution_study`` (the detector per input resolution and serving path)
and ``int8_saturation_study`` (static int8 under overexposure per
calibration margin). Nothing is loaded here."""
