from repro_torch.serving.admission import (
    AdmissionController, SERVING_TRES_WEIGHTS, Tenant,
)
from repro_torch.serving.engine import DecodeEngine, Request

__all__ = ["AdmissionController", "DecodeEngine", "Request",
           "SERVING_TRES_WEIGHTS", "Tenant"]
