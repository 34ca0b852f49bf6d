from repro_torch.serving.admission import (
    AdmissionController, SERVING_TRES_WEIGHTS, Tenant,
)
from repro_torch.serving.engine import DecodeEngine, Request
from repro_torch.serving.prefix import PrefixCache, RadixNode
from repro_torch.serving.spec import (
    ModelDraftSource, NgramDraftSource, NgramIndex, draft_config,
    greedy_accept, rejection_sample,
)

__all__ = ["AdmissionController", "DecodeEngine", "ModelDraftSource",
           "NgramDraftSource", "NgramIndex", "PrefixCache", "RadixNode",
           "Request", "SERVING_TRES_WEIGHTS", "Tenant", "draft_config",
           "greedy_accept", "rejection_sample"]
