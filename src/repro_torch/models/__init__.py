from repro_torch.models.init import init_params
from repro_torch.models.model import (
    decode_n, decode_step, init_cache, prefill,
)
from repro_torch.models.paging import PageAllocator, PagedKVConfig, pages_for
from repro_torch.models.spec import count_params, model_spec

__all__ = [
    "init_params", "decode_n", "decode_step", "init_cache",
    "prefill", "PageAllocator", "PagedKVConfig", "pages_for",
    "count_params", "model_spec",
]
