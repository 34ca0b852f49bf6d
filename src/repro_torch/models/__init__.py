from repro_torch.models.init import init_params
from repro_torch.models.inputs import make_batch
from repro_torch.models.model import (
    decode_n, decode_step, forward_train, init_cache, loss_fn, prefill,
)
from repro_torch.models.paging import PageAllocator, PagedKVConfig, pages_for
from repro_torch.models.spec import count_params, model_spec

__all__ = [
    "init_params", "make_batch", "decode_n", "decode_step",
    "forward_train", "init_cache", "loss_fn", "prefill", "PageAllocator",
    "PagedKVConfig", "pages_for", "count_params", "model_spec",
]
