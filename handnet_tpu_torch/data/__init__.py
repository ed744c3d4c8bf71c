"""Host-side data of the port: ``image_io`` (16-bit PNG read/write),
``yaml_lite`` (DexYCB's YAML subset), ``rle`` (COCO RLE masks), ``dexycb``
(the dataset reader), ``synthetic`` (the synthetic DexYCB tree),
``a2j_data`` (A2J samples) and ``loader`` (``PrefetchLoader``). None of them
imports ``cv2``, ``yaml`` or PIL. Import submodules directly; nothing is
loaded here."""
