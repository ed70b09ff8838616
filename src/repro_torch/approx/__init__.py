"""Adaptive-sampling approximate betweenness centrality.

Exact MFBC (``repro_torch.core.mfbc``) runs all ``n`` sources through the
batched Algorithm 3 step. This package serves the sampling regime instead:
pick sources uniformly at random, run the same batch step, and stop as
soon as per-vertex confidence intervals certify the requested accuracy —
the adaptive-sampling design of van der Grinten & Meyerhenke
[arXiv:1910.11039]. ``sampling`` holds the strategies and CI rules,
``driver`` the estimator; the epoch loop is ``repro_torch.bc.solve``.
Both modules are copies of the reference's, held to the same streams and
statistics by ``tests/test_torch_approx.py``.
"""
from repro_torch.approx.driver import ApproxResult, choose_sample_batch
from repro_torch.approx.sampling import (AdaptiveSampler, UniformSampler,
                                         allocate_delta, bernstein_halfwidth,
                                         epoch_schedule, hoeffding_budget,
                                         normal_halfwidth)

__all__ = [
    "ApproxResult", "choose_sample_batch",
    "AdaptiveSampler", "UniformSampler", "allocate_delta",
    "bernstein_halfwidth", "epoch_schedule", "hoeffding_budget",
    "normal_halfwidth",
]
