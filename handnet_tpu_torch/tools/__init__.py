"""The port's learning gates: ``synthetic_e2e_validation`` (both stages
trained from scratch, then the assembled pipeline, float and int8) and
``rcnn_convergence`` (the Faster R-CNN beside an FCOS control), with the
pieces they share in ``gates``. Nothing is loaded here."""
