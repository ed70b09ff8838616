"""Hand-written Hopper kernels of the relaxations and their wrappers.

``csrc/`` holds the CUDA sources, ``_build`` compiles them at first use,
``tropical_mm`` / ``centpath_mm`` wrap the two products and ``ops``
dispatches them by device; ``segment_relax`` wraps and dispatches the
sparse relax of the COO and CSR backends; ``ref`` holds the plain
PyTorch versions of all three.
"""
