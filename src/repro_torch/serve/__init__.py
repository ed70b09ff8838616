"""repro_torch.serve — the approximate-BC serving stack, front to back.

Three layers, outermost first:

* ``gateway`` — the wire: a stdlib HTTP front (``BCGateway`` +
  ``start_gateway``) exposing submit/poll/graphs/metrics JSON
  endpoints, with overload-aware admission (predicted-seconds backlog
  vs a deadline horizon; reject or degrade) and per-tier
  ``GatewayMetrics``.
* ``cache`` — the content-addressed ``ResultCache``: finished answers
  keyed on graph digest + (δ, k, rule, tier); equal-or-tighter ε hits
  instantly, looser entries refine from their checkpoint.
* ``bc_service`` — the solver loop: ``BCService`` tick-scheduling
  ``BCRequest``s over slot-fused adaptive sampling, retiring
  ``BCResponse``s (JSON round-trippable, optionally checkpointed).

A copy of ``repro.serve`` over ``repro_torch.bc``, on the card by
default (``BCService(device="cuda")``). Beside the BC stack,
``engine.ServeEngine`` is the LM's continuous-batching engine over
``repro_torch.models.transformer`` (slot-based prefill and decode on its
model's device; ``launch.serve`` drives the same model without it).
"""
from repro_torch.serve.bc_service import BCRequest, BCResponse, BCService
from repro_torch.serve.cache import HIT, MISS, REFINE, CacheEntry, ResultCache
from repro_torch.serve.gateway import (BCGateway, GatewayConfig,
                                       GatewayMetrics, GatewayServer,
                                       start_gateway)

__all__ = [
    "BCRequest", "BCResponse", "BCService",
    "CacheEntry", "ResultCache", "HIT", "REFINE", "MISS",
    "BCGateway", "GatewayConfig", "GatewayMetrics", "GatewayServer",
    "start_gateway",
]
