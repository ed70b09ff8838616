"""Hand-written Hopper kernels of the relaxations and their wrappers.

``csrc/`` holds the CUDA sources, ``_build`` compiles them at first use,
``tropical_mm`` / ``centpath_mm`` wrap the two products and ``ops``
dispatches them by device; ``segment_relax`` wraps and dispatches the
sparse relax of the COO and CSR backends; ``child_count`` and
``csr_expand`` wrap the dense SP-DAG child count and the CSR arc
expansion, whose plain versions live in ``core.monoids``; ``ref`` holds
the plain PyTorch versions of the other three.
"""
