"""Config system: model architecture + run configs (a copy of the JAX
package's ``configs/base.py``, trimmed to what the port runs).

Every ported architecture gets one ``<arch>.py`` in this package exporting
``CONFIG: ModelConfig`` with the exact published dimensions, plus a
``reduced()`` variant used by CPU tests (2 layers, d_model<=512, <=4
experts — same family, same code paths).
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, replace
from typing import Optional


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0          # routed experts
    top_k: int = 0
    num_shared: int = 0           # always-on shared experts (qwen2-moe)
    d_ff: int = 0                 # per-expert hidden dim
    every: int = 1                # MoE FFN every `every` layers (others dense)
    capacity_factor: float = 1.25
    group_size: int = 1024        # GShard dispatch group size (tokens)
    router_z_coef: float = 1e-3   # router z-loss
    balance_coef: float = 1e-2    # load-balance aux loss


@dataclass(frozen=True)
class SSMConfig:
    state: int = 128              # N — SSD state size
    head_dim: int = 64            # P — channels per SSD head
    expand: int = 2               # d_inner = expand * d_model
    conv_width: int = 4
    chunk: int = 256              # SSD chunk length

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def num_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    source: str                   # citation from the assignment table
    num_layers: int
    d_model: int
    num_heads: int                # query heads (0 for attn-free)
    num_kv_heads: int
    d_ff: int                     # dense FFN hidden dim (0 if pure-MoE FFN)
    vocab_size: int
    head_dim: int = 128
    # attention details
    rope_theta: float = 1e4
    qkv_bias: bool = False
    pos_embedding: str = "rope"   # rope | sinusoidal | none (NoPE)
    sliding_window: Optional[int] = None  # None = full causal
    # FFN
    mlp_type: str = "swiglu"      # swiglu | gelu | relu2
    # mixer schedule (hybrid): 1 attention layer per `attn_every` layers,
    # the rest SSM.  attn_every=1 => all attention; 0 => attention-free.
    attn_every: int = 1
    # the attention layer's place in each period of `attn_every` layers
    attn_offset: int = 0
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # modality frontend stub: none | vision | audio
    frontend: str = "none"
    num_codebooks: int = 1        # audio (EnCodec streams)
    # numerics
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"       # compute dtype
    param_dtype: str = "float32"  # storage dtype
    tie_embeddings: bool = False
    # muP scalars (Granite): the token embedding times
    # `embedding_multiplier`, every sublayer's output times
    # `residual_multiplier` before its residual add, the attention softmax
    # scale `attention_multiplier` (None: 1/sqrt(head_dim)), the logits
    # divided by `logits_scaling`.  The defaults change nothing.
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    attention_multiplier: Optional[float] = None
    logits_scaling: float = 1.0

    # ---- derived ----
    def layer_kinds(self) -> list[str]:
        """Mixer kind per layer: 'attn' or 'ssm'."""
        if self.attn_every == 0:
            return ["ssm"] * self.num_layers
        return ["attn" if i % self.attn_every == self.attn_offset else "ssm"
                for i in range(self.num_layers)]

    def ffn_kinds(self) -> list[str]:
        """FFN kind per layer: 'dense' or 'moe'."""
        if self.moe is None:
            return ["dense"] * self.num_layers
        return [
            "moe" if (i % self.moe.every == self.moe.every - 1) else "dense"
            for i in range(self.num_layers)
        ]

    def with_sliding_window(self, window: int) -> "ModelConfig":
        return replace(self, sliding_window=window)

    def param_count(self) -> int:
        """Total parameter count (exact, mirrors the spec tree)."""
        from repro_torch.models.spec import count_params
        return count_params(self)

    def active_param_count(self) -> int:
        from repro_torch.models.spec import count_params
        return count_params(self, active_only=True)


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

# Sliding-window size used for the long_500k variant of full-attention archs.
LONG_CONTEXT_WINDOW = 8_192


@dataclass(frozen=True)
class RunConfig:
    """Parallelism + execution knobs for one (arch x shape x mesh) run:
    the JAX package's ``RunConfig`` with ``use_kernels`` in place of its
    ``use_pallas``.

    ``use_kernels`` True routes attention and the SSD scan through
    ``repro_torch.kernels.ops`` (the hand-written CUDA kernels on a CUDA
    tensor, their plain versions on a CPU tensor); False runs the
    reference paths of ``models.attention`` and ``models.ssm``.  The
    serving and training entry points set it True.

    ``strategy`` and ``zero_stage`` place parameters, gradients and
    optimizer state on the ``(data, model)`` mesh of ranks
    (``core.sharding``, ``core.zero``); ``gather_bf16`` and
    ``grad_reduce_bf16`` move the ZeRO-3 gathers and the gradient
    reductions in bf16, as in the JAX step.  ``seq_parallel`` computes
    training attention in one q block (the JAX ``one_block``) and, under
    a TP strategy on more than one ``model`` rank, shards the residual
    stream's sequence there (``models.model.forward_train``);
    ``moe_defer_combine`` moves the TP-in-expert reduction from the
    expert outputs to after the combine (``models.moe``).  Neither
    changes the numbers.  ``unroll`` is accepted and does nothing: it
    makes the JAX step's scans straight-line HLO for XLA's cost
    analysis, and the port's loops are Python loops already."""
    strategy: str = "fsdp_tp"     # dp | tp | fsdp | fsdp_tp | pp
    zero_stage: int = 3           # 1 | 2 | 3 (ZeRO partitioning depth)
    microbatches: int = 1         # gradient-accumulation microbatches
    remat: str = "layer"          # none | layer | full
    opt_state_dtype: str = "float32"
    use_kernels: bool = False
    seq_shard_decode: bool = False  # shard decode KV cache along sequence
    seq_parallel: bool = False
    gather_bf16: bool = False
    moe_defer_combine: bool = False
    grad_reduce_bf16: bool = False
    unroll: bool = False


ARCH_IDS = [
    "jamba-1.5-large-398b",
    "starcoder2-3b",
    "pixtral-12b",
    "qwen2-moe-a2.7b",
    "musicgen-large",
    "qwen2-7b",
    "stablelm-3b",
    "mamba2-780m",
    "dbrx-132b",
    "minitron-4b",
]


#: architectures the port serves beyond the JAX package's ten
PORT_ARCH_IDS = [
    "granite-4.0-h-micro",
]


def _module_name(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "_")


def get_config(arch_id: str) -> ModelConfig:
    mod = importlib.import_module(
        f"repro_torch.configs.{_module_name(arch_id)}")
    return mod.CONFIG


def get_reduced_config(arch_id: str) -> ModelConfig:
    mod = importlib.import_module(
        f"repro_torch.configs.{_module_name(arch_id)}")
    return mod.reduced()


def default_opt_state_dtype(cfg: ModelConfig) -> str:
    """The AdamW moments' dtype by default: bf16 above 100B parameters."""
    return "bfloat16" if cfg.param_count() > 100e9 else "float32"


def default_run_config(cfg: ModelConfig, shape: InputShape,
                       batch_divisor: int = 32) -> RunConfig:
    """Production defaults per (arch, shape), as the JAX package's.

    ``batch_divisor`` = product of batch-carrying mesh axes (pod*data); the
    per-microbatch batch must stay divisible by it so the batch dim shards
    cleanly at every microbatch step.  Microbatches scale with ``d_model *
    layers`` to keep each rank's live activations to a few GB;
    ``use_kernels`` stays False, as the JAX ``use_pallas`` does.
    """
    micro = 1
    if shape.kind == "train":
        cost = cfg.d_model * cfg.num_layers
        if cost >= 400_000:
            micro = 16
        elif cost >= 150_000:
            micro = 8
        elif cost >= 64_000:
            micro = 4
        else:
            micro = 2
        micro = max(1, min(micro, shape.global_batch // batch_divisor))
    return RunConfig(microbatches=micro,
                     opt_state_dtype=default_opt_state_dtype(cfg))


def shape_for(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """Adapt an arch config to an input shape (long-context window)."""
    if shape.name == "long_500k" and cfg.attn_every != 0:
        # sub-quadratic requirement: dense/hybrid archs use sliding window.
        if cfg.sliding_window is None or \
                cfg.sliding_window > LONG_CONTEXT_WINDOW:
            return cfg.with_sliding_window(LONG_CONTEXT_WINDOW)
    return cfg
