"""The sparse-expert attention family (Qwen2-MoE's block), from a
configuration file's published widths: the leaves the benchmark draws
(the port's parameter tree), the keyword arguments of the port's
``ModelConfig`` with its ``moe`` group, and the model FLOPs that
``mfu.*`` count.  Its reference math is ``reference/moe.py``.

Every layer is attention (q, k and v with biases, rotary positions on
the whole head) and a sparse-expert FFN: a router over ``num_experts``
experts of width ``moe_intermediate_size``, ``num_experts_per_tok`` of
them a token, beside one shared SwiGLU of width
``shared_expert_intermediate_size`` (the port's ``num_shared`` experts of
the routed width side by side).  ``port_moe`` holds what the port's
dispatch runs with and the published model does not state: capacity
factor, token group, and the router losses' weights.

Keys are accounted for as in ``families/dense.py``: mapped, describing
the file, fixed to the one value this family runs, or listed under
``port_departures``; any other key, or a fixed one set otherwise, is
refused."""
from __future__ import annotations

MAPPED = ("num_hidden_layers", "hidden_size", "num_attention_heads",
          "num_key_value_heads", "head_dim", "vocab_size", "rope_theta",
          "rms_norm_eps", "tie_word_embeddings", "num_experts",
          "num_experts_per_tok", "moe_intermediate_size",
          "shared_expert_intermediate_size", "port_moe")
#: options this family's port mapping and reference run one way only
FIXED = {"hidden_act": "silu", "qkv_bias": True, "use_sliding_window": False,
         "decoder_sparse_step": 1}
#: ``intermediate_size`` is the dense FFN's width, which no layer has
#: (every layer is sparse: ``decoder_sparse_step`` 1)
ABOUT = ("name", "family", "source", "reduced", "assumed",
         "port_departures", "dtypes", "max_position_embeddings",
         "intermediate_size", "deployment")
PORT_MOE = ("capacity_factor", "group_size", "balance_coef",
            "router_z_coef")


def check(c: dict) -> None:
    """Raise unless every key of the file is one this family accounts
    for, every fixed option is stated with the value the family runs,
    and the shared width is a whole number of routed experts."""
    departs = set(c.get("port_departures", {}))
    unknown = sorted(k for k in c if k not in MAPPED and k not in FIXED
                     and k not in ABOUT and k not in departs)
    wrong = sorted(k for k, v in FIXED.items() if c.get(k) != v)
    missing = sorted(k for k in MAPPED if k not in c
                     and k != "tie_word_embeddings")
    problems = [f"keys it does not map {unknown}" if unknown else "",
                f"{wrong} not stated as {FIXED}" if wrong else "",
                f"no {missing}" if missing else ""]
    if not missing:
        if sorted(c["port_moe"]) != sorted(PORT_MOE):
            problems.append(f"port_moe must give exactly {PORT_MOE}")
        if c["shared_expert_intermediate_size"] % c["moe_intermediate_size"]:
            problems.append("a shared width that is not a whole number of "
                            "routed experts")
    if any(problems):
        raise ValueError(
            f"{c.get('name')}, moe family: "
            + "; ".join(p for p in problems if p)
            + ". Such a model needs a family file of its own.")


def vocab(c: dict) -> int:
    return c["vocab_size"]


def port_kwargs(c: dict) -> dict:
    """The port's ``ModelConfig`` fields (without the dtypes); ``moe`` is
    the port's ``MoEConfig`` as a dict."""
    check(c)
    f = c["moe_intermediate_size"]
    m = c["port_moe"]
    return dict(
        name=c["name"], family="moe", source=c["source"],
        num_layers=c["num_hidden_layers"], d_model=c["hidden_size"],
        num_heads=c["num_attention_heads"],
        num_kv_heads=c["num_key_value_heads"], head_dim=c["head_dim"],
        d_ff=0, vocab_size=c["vocab_size"],
        rope_theta=float(c["rope_theta"]), norm_eps=float(c["rms_norm_eps"]),
        tie_embeddings=bool(c.get("tie_word_embeddings", False)),
        qkv_bias=True, mlp_type="swiglu", sliding_window=None,
        moe=dict(num_experts=c["num_experts"], top_k=c["num_experts_per_tok"],
                 num_shared=c["shared_expert_intermediate_size"] // f,
                 d_ff=f, every=1,
                 capacity_factor=float(m["capacity_factor"]),
                 group_size=int(m["group_size"]),
                 router_z_coef=float(m["router_z_coef"]),
                 balance_coef=float(m["balance_coef"])))


def leaves(c: dict) -> list:
    """``[(path, shape, init, scale)]``, layers stacked on dim 0."""
    d, H, K = c["hidden_size"], c["num_attention_heads"], \
        c["num_key_value_heads"]
    Dh, V, L = c["head_dim"], c["vocab_size"], c["num_hidden_layers"]
    E, f, fs = c["num_experts"], c["moe_intermediate_size"], \
        c["shared_expert_intermediate_size"]
    s = d ** -0.5
    pre = "layers.0."
    out = [
        ("embed.tok", (V, d), "normal", s),
        (pre + "norm1.scale", (L, d), "ones", None),
        (pre + "attn.wq", (L, d, H, Dh), "normal", s),
        (pre + "attn.wk", (L, d, K, Dh), "normal", s),
        (pre + "attn.wv", (L, d, K, Dh), "normal", s),
        (pre + "attn.wo", (L, H, Dh, d), "normal", (H * Dh) ** -0.5),
        (pre + "attn.bq", (L, H, Dh), "zeros", None),
        (pre + "attn.bk", (L, K, Dh), "zeros", None),
        (pre + "attn.bv", (L, K, Dh), "zeros", None),
        (pre + "norm2.scale", (L, d), "ones", None),
        (pre + "moe.router", (L, d, E), "normal", s),
        (pre + "moe.w1", (L, E, d, f), "normal", s),
        (pre + "moe.w2", (L, E, f, d), "normal", f ** -0.5),
        (pre + "moe.w3", (L, E, d, f), "normal", s),
        (pre + "moe.shared.w1", (L, d, fs), "normal", s),
        (pre + "moe.shared.w2", (L, fs, d), "normal", fs ** -0.5),
        (pre + "moe.shared.w3", (L, d, fs), "normal", s),
        ("final_norm.scale", (d,), "ones", None),
    ]
    if not c.get("tie_word_embeddings", False):
        out.append(("lm_head.w", (V, d), "normal", s))
    return out


def attention_heads(c: dict) -> tuple:
    """``(query heads, kv heads, head size)`` of the attention kernels."""
    return c["num_attention_heads"], c["num_key_value_heads"], c["head_dim"]


def body_flops(c: dict) -> int:
    """2 x the weights a token's products use in every layer, counted at
    the active widths: the q, k, v and o projections, the router, the
    ``num_experts_per_tok`` routed SwiGLUs it is sent to and the shared
    one.  Capacity slots left empty and tokens dropped at a full expert
    are not work the inputs need."""
    d, H, K, Dh = (c["hidden_size"], c["num_attention_heads"],
                   c["num_key_value_heads"], c["head_dim"])
    L, E, k = c["num_hidden_layers"], c["num_experts"], \
        c["num_experts_per_tok"]
    f, fs = c["moe_intermediate_size"], c["shared_expert_intermediate_size"]
    return 2 * L * (d * (H + 2 * K) * Dh + H * Dh * d + d * E
                    + 3 * d * (k * f + fs))


def head_flops(c: dict) -> int:
    """The output head: FLOPs a token whose logits are made."""
    return 2 * c["hidden_size"] * c["vocab_size"]


def pair_flops(c: dict) -> int:
    """Attention of one query over one key line: 4 x heads x head size a
    layer (q.k and p.v)."""
    return 4 * c["num_hidden_layers"] * c["num_attention_heads"] \
        * c["head_dim"]


def mixer_flops(c: dict, n: int, start: int) -> int:
    """Attention of ``n`` new tokens after ``start`` cached ones, causal
    among the new."""
    return pair_flops(c) * (n * start + n * (n + 1) // 2)


def forward_flops(c: dict, rows: int, S: int) -> int:
    """A training forward over ``rows`` causal rows of ``S`` tokens."""
    return rows * (S * (body_flops(c) + head_flops(c))
                   + mixer_flops(c, S, 0))
