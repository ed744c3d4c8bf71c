"""Build and load the port's CUDA kernels (``build.load_library``)."""
