"""Parameter spec trees — the single source of truth for shapes, logical
sharding axes, and init styles of every model family.

A spec tree mirrors the parameter pytree; each leaf is a :class:`ParamSpec`.
``repro_torch.models.init`` materializes tensors from it.  The logical
axes are kept as the JAX package has them (its ``core.sharding`` maps them
onto mesh axes); the port runs on one card and reads only shapes and init
styles.

Layer stacking: layers repeat with period ``P = lcm(attn_every, moe.every)``;
parameters of the P sublayers are stacked with a leading ``layers`` axis of
size ``num_layers // P`` and the forward pass is a Python loop over groups.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.configs.base import ModelConfig

# Logical axis vocabulary (see core/sharding.py for the mesh mapping):
#   layers     — scan-stacking axis (sharded only under pipeline parallelism)
#   vocab      — vocabulary dim              (tensor-parallel candidate)
#   embed      — model/residual dim          (ZeRO/FSDP candidate)
#   heads      — attention query heads       (tensor-parallel candidate)
#   kv_heads   — attention kv heads          (tensor-parallel candidate)
#   head_dim   — per-head dim                (never sharded)
#   ffn        — FFN hidden dim              (tensor-parallel candidate)
#   experts    — MoE expert dim              (expert-parallel candidate)
#   ssm_inner  — SSD inner dim               (tensor-parallel candidate)
#   ssm_head   — SSD heads                   (tensor-parallel candidate)
#   ssm_state / conv — SSD small dims        (never sharded)


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[Optional[str], ...]
    init: str = "normal"          # normal | zeros | ones | a_log | dt_bias
    scale: Optional[float] = None  # stddev override for "normal"

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def stacked(self, n: int) -> "ParamSpec":
        return ParamSpec((n,) + self.shape, ("layers",) + self.axes,
                         self.init, self.scale)


def _norm(d: int) -> dict:
    return {"scale": ParamSpec((d,), ("embed",), "ones")}


def attention_spec(cfg: ModelConfig) -> dict:
    d, H, K, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s = d ** -0.5
    spec = {
        "wq": ParamSpec((d, H, Dh), ("embed", "heads", "head_dim"), scale=s),
        "wk": ParamSpec((d, K, Dh), ("embed", "kv_heads", "head_dim"), scale=s),
        "wv": ParamSpec((d, K, Dh), ("embed", "kv_heads", "head_dim"), scale=s),
        "wo": ParamSpec((H, Dh, d), ("heads", "head_dim", "embed"),
                        scale=(H * Dh) ** -0.5),
    }
    if cfg.qkv_bias:
        spec["bq"] = ParamSpec((H, Dh), ("heads", "head_dim"), "zeros")
        spec["bk"] = ParamSpec((K, Dh), ("kv_heads", "head_dim"), "zeros")
        spec["bv"] = ParamSpec((K, Dh), ("kv_heads", "head_dim"), "zeros")
    return spec


def ssm_spec(cfg: ModelConfig) -> dict:
    ssm = cfg.ssm
    d = cfg.d_model
    di = ssm.d_inner(d)
    H = ssm.num_heads(d)
    N = ssm.state
    conv_ch = di + 2 * N              # conv over [x, B, C]
    s = d ** -0.5
    return {
        "wz": ParamSpec((d, di), ("embed", "ssm_inner"), scale=s),
        "wx": ParamSpec((d, di), ("embed", "ssm_inner"), scale=s),
        "wB": ParamSpec((d, N), ("embed", "ssm_state"), scale=s),
        "wC": ParamSpec((d, N), ("embed", "ssm_state"), scale=s),
        "wdt": ParamSpec((d, H), ("embed", "ssm_head"), scale=s),
        # conv channel dim is the concat [x, B, C] — semantically unsplittable
        # under TP (B/C must be replicated per head shard); ZeRO may still
        # storage-shard it on the data axis.
        "conv_w": ParamSpec((ssm.conv_width, conv_ch), ("conv", None),
                            scale=ssm.conv_width ** -0.5),
        "conv_b": ParamSpec((conv_ch,), (None,), "zeros"),
        "A_log": ParamSpec((H,), ("ssm_head",), "a_log"),
        "D": ParamSpec((H,), ("ssm_head",), "ones"),
        "dt_bias": ParamSpec((H,), ("ssm_head",), "dt_bias"),
        "norm_scale": ParamSpec((di,), ("ssm_inner",), "ones"),
        "wo": ParamSpec((di, d), ("ssm_inner", "embed"), scale=di ** -0.5),
    }


def mlp_spec(d: int, f: int, mlp_type: str) -> dict:
    s_in, s_out = d ** -0.5, f ** -0.5
    spec = {
        "w1": ParamSpec((d, f), ("embed", "ffn"), scale=s_in),
        "w2": ParamSpec((f, d), ("ffn", "embed"), scale=s_out),
    }
    if mlp_type == "swiglu":
        spec["w3"] = ParamSpec((d, f), ("embed", "ffn"), scale=s_in)
    return spec


def moe_spec(cfg: ModelConfig) -> dict:
    moe = cfg.moe
    d, E, f = cfg.d_model, moe.num_experts, moe.d_ff
    s_in, s_out = d ** -0.5, f ** -0.5
    spec = {
        "router": ParamSpec((d, E), ("embed", None), scale=s_in),
        "w1": ParamSpec((E, d, f), ("experts", "embed", "ffn"), scale=s_in),
        "w2": ParamSpec((E, f, d), ("experts", "ffn", "embed"), scale=s_out),
    }
    if cfg.mlp_type == "swiglu":
        spec["w3"] = ParamSpec((E, d, f), ("experts", "embed", "ffn"),
                               scale=s_in)
    if moe.num_shared:
        spec["shared"] = mlp_spec(d, f * moe.num_shared, cfg.mlp_type)
    return spec


def sublayer_spec(cfg: ModelConfig, mixer: str, ffn: str) -> dict:
    d = cfg.d_model
    spec = {"norm1": _norm(d)}
    if mixer == "attn":
        spec["attn"] = attention_spec(cfg)
    else:
        spec["ssm"] = ssm_spec(cfg)
    if ffn != "none":
        spec["norm2"] = _norm(d)
        if ffn == "moe":
            spec["moe"] = moe_spec(cfg)
        else:
            spec["mlp"] = mlp_spec(d, cfg.d_ff, cfg.mlp_type)
    return spec


def layer_schedule(cfg: ModelConfig) -> list[tuple[str, str]]:
    """(mixer, ffn) per layer.

    Pure-SSM archs (mamba2) have no separate FFN — the mamba block is the
    whole layer.  MoE-every-layer archs have ffn='moe' everywhere.
    """
    mixers = cfg.layer_kinds()
    if cfg.family == "ssm":
        ffns = ["none"] * cfg.num_layers
    else:
        ffns = cfg.ffn_kinds()
    return list(zip(mixers, ffns))


def group_period(cfg: ModelConfig) -> int:
    sched = layer_schedule(cfg)
    for p in range(1, len(sched) + 1):
        if len(sched) % p == 0 and all(
            sched[i] == sched[i % p] for i in range(len(sched))
        ):
            return p
    return len(sched)


def model_spec(cfg: ModelConfig) -> dict:
    """Full parameter spec tree (stacked layer groups)."""
    P = group_period(cfg)
    n_groups = cfg.num_layers // P
    sched = layer_schedule(cfg)
    sublayers = []
    for i in range(P):
        mixer, ffn = sched[i]
        sub = sublayer_spec(cfg, mixer, ffn)
        sublayers.append(_map_specs(sub, lambda ps: ps.stacked(n_groups)))
    spec = {
        "embed": {
            "tok": ParamSpec((cfg.vocab_size, cfg.d_model),
                             ("vocab", "embed"), scale=1.0 * cfg.d_model ** -0.5)
        },
        "layers": sublayers,
        "final_norm": _norm(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        spec["lm_head"] = {
            "w": ParamSpec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                           scale=cfg.d_model ** -0.5)
        }
    return spec


def _map_specs(tree, fn):
    if isinstance(tree, ParamSpec):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_specs(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_specs(v, fn) for v in tree]
    raise TypeError(type(tree))


def iter_specs(tree, prefix=""):
    if isinstance(tree, ParamSpec):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from iter_specs(v, f"{prefix}/{k}" if prefix else k)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from iter_specs(v, f"{prefix}/{i}" if prefix else str(i))
    else:
        raise TypeError(type(tree))


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Exact parameter count; ``active_only`` counts top-k+shared experts
    instead of all routed experts (for MODEL_FLOPS = 6*N_active*D)."""
    total = 0
    for name, ps in iter_specs(model_spec(cfg)):
        n = ps.size
        if active_only and "/moe/w" in name and cfg.moe:
            n = n * (cfg.moe.top_k / cfg.moe.num_experts)
        total += int(n)
    return total
