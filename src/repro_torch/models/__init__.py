from repro_torch.models.init import abstract_params, init_params
from repro_torch.models.inputs import (
    decode_input_specs, input_specs, make_batch, train_input_specs,
)
from repro_torch.models.model import (
    decode_n, decode_step, forward_train, init_cache, loss_fn, prefill,
)
from repro_torch.models.paging import PageAllocator, PagedKVConfig, pages_for
from repro_torch.models.spec import count_params, model_spec

__all__ = [
    "abstract_params", "decode_input_specs", "init_params", "input_specs",
    "make_batch", "train_input_specs", "decode_n", "decode_step",
    "forward_train", "init_cache", "loss_fn", "prefill", "PageAllocator",
    "PagedKVConfig", "pages_for", "count_params", "model_spec",
]
