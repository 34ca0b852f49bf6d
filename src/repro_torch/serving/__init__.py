from repro_torch.serving.admission import (
    AdmissionController, SERVING_TRES_WEIGHTS, Tenant,
)
from repro_torch.serving.autoscale import Autoscaler
from repro_torch.serving.engine import DecodeEngine, Request
from repro_torch.serving.prefix import PrefixCache, RadixNode
from repro_torch.serving.router import HashRing, Router, affinity_key
from repro_torch.serving.serve_step import (
    chunked_serve_step_lowering_args, fused_serve_step_lowering_args,
    make_chunked_serve_step, make_fused_serve_step, make_serve_step,
    serve_step_lowering_args,
)
from repro_torch.serving.spec import (
    ModelDraftSource, NgramDraftSource, NgramIndex, draft_config,
    greedy_accept, rejection_sample,
)

__all__ = ["AdmissionController", "Autoscaler", "DecodeEngine", "HashRing",
           "ModelDraftSource", "NgramDraftSource", "NgramIndex",
           "PrefixCache", "RadixNode", "Request", "Router",
           "SERVING_TRES_WEIGHTS", "Tenant", "affinity_key",
           "chunked_serve_step_lowering_args", "draft_config",
           "fused_serve_step_lowering_args", "greedy_accept",
           "make_chunked_serve_step", "make_fused_serve_step",
           "make_serve_step", "rejection_sample",
           "serve_step_lowering_args"]
