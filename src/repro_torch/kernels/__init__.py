"""Hand-written Hopper kernels for the two relaxations and their wrappers.

``csrc/`` holds the CUDA sources, ``_build`` compiles them at first use,
``tropical_mm`` / ``centpath_mm`` wrap them, ``ref`` holds their plain
PyTorch versions and ``ops`` dispatches by device.
"""
