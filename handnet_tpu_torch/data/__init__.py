"""Host-side data of the port: ``image_io`` (16-bit PNG read/write, colour
JPEG through ``jpeg``, cv2's bilinear resize), ``jpeg`` (the baseline JPEG
codec), ``yaml_lite`` (DexYCB's YAML subset), ``rle`` (COCO RLE masks),
``dexycb`` (the dataset reader), ``synthetic`` (the synthetic DexYCB tree),
``a2j_data`` (A2J samples), ``detect_data`` (DexYCB detection targets),
``e2e_data`` (full-frame E2E samples, the MANO mesh regenerated on the
layer's device), ``sequence`` (the multi-camera sequence loader, its depth
deprojected on the device), ``imgtrans`` (colour jitter), ``voc100doh``
(100DOH in VOC layout) and ``loader`` (``PrefetchLoader``). None of them
imports ``cv2``, ``yaml`` or PIL. Import submodules directly; nothing is
loaded here."""
