"""Core MFBC algorithms: monoids, the dense adjacency, MFBF, MFBr, MFBC,
and the numpy Brandes oracle. Import the modules directly, e.g.
``from repro_torch.core.mfbc import mfbc``."""
