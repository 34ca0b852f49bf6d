from repro_torch.serving.admission import (
    AdmissionController, SERVING_TRES_WEIGHTS, Tenant,
)
from repro_torch.serving.autoscale import Autoscaler
from repro_torch.serving.engine import DecodeEngine, Request
from repro_torch.serving.prefix import PrefixCache, RadixNode
from repro_torch.serving.router import HashRing, Router, affinity_key
from repro_torch.serving.spec import (
    ModelDraftSource, NgramDraftSource, NgramIndex, draft_config,
    greedy_accept, rejection_sample,
)

__all__ = ["AdmissionController", "Autoscaler", "DecodeEngine", "HashRing",
           "ModelDraftSource", "NgramDraftSource", "NgramIndex",
           "PrefixCache", "RadixNode", "Request", "Router",
           "SERVING_TRES_WEIGHTS", "Tenant", "affinity_key", "draft_config",
           "greedy_accept", "rejection_sample"]
