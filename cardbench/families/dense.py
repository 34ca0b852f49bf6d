"""The dense attention family, from a configuration file's published
widths: the leaves the benchmark draws (the port's parameter tree), the
keyword arguments of the port's ``ModelConfig``, and the model FLOPs that
``mfu.*`` count.  Its reference math is ``reference/dense.py``.

Every key of a configuration file of this family is read here
(``MAPPED``), describes the file (``ABOUT``), is a published option that
this family runs one way only (``FIXED``, with that value), or names a
published option where the port departs, listed under the same key in
the file's ``port_departures``.  Any other key, or a fixed option set
another way, is refused: the port would build another model than the
file describes, and the reference would agree with it."""
from __future__ import annotations

MAPPED = ("num_hidden_layers", "hidden_size", "num_attention_heads",
          "num_key_value_heads", "head_dim", "intermediate_size",
          "vocab_size", "rope_theta", "norm_eps", "tie_word_embeddings")
#: options this family's port mapping and reference run one way only
FIXED = {"hidden_act": "silu", "use_qkv_bias": False}
ABOUT = ("name", "family", "source", "reduced", "assumed",
         "port_departures", "dtypes", "max_position_embeddings")


def check(c: dict) -> None:
    """Raise unless every key of the file is one this family accounts
    for, and every fixed option is stated with the value the family
    runs."""
    departs = set(c.get("port_departures", {}))
    unknown = sorted(k for k in c if k not in MAPPED and k not in FIXED
                     and k not in ABOUT and k not in departs)
    wrong = sorted(k for k, v in FIXED.items() if c.get(k) != v)
    missing = sorted(k for k in MAPPED if k not in c
                     and k != "tie_word_embeddings")
    problems = [f"keys it does not map {unknown}" if unknown else "",
                f"{wrong} not stated as {FIXED}" if wrong else "",
                f"no {missing}" if missing else ""]
    if any(problems):
        raise ValueError(
            f"{c.get('name')}, dense family: "
            + "; ".join(p for p in problems if p)
            + ". Such a model needs a family file of its own.")


def vocab(c: dict) -> int:
    return c["vocab_size"]


def port_kwargs(c: dict) -> dict:
    """The port's ``ModelConfig`` fields (without the dtypes)."""
    check(c)
    return dict(
        name=c["name"], family="dense", source=c["source"],
        num_layers=c["num_hidden_layers"], d_model=c["hidden_size"],
        num_heads=c["num_attention_heads"],
        num_kv_heads=c["num_key_value_heads"], head_dim=c["head_dim"],
        d_ff=c["intermediate_size"], vocab_size=c["vocab_size"],
        rope_theta=float(c["rope_theta"]), norm_eps=float(c["norm_eps"]),
        tie_embeddings=bool(c.get("tie_word_embeddings", False)),
        qkv_bias=False, mlp_type="swiglu", sliding_window=None)


def leaves(c: dict) -> list:
    """``[(path, shape, init, scale)]``, layers stacked on dim 0."""
    d, H, K = c["hidden_size"], c["num_attention_heads"], \
        c["num_key_value_heads"]
    Dh, f, V, L = c["head_dim"], c["intermediate_size"], c["vocab_size"], \
        c["num_hidden_layers"]
    s = d ** -0.5
    pre = "layers.0."
    out = [
        ("embed.tok", (V, d), "normal", s),
        (pre + "norm1.scale", (L, d), "ones", None),
        (pre + "attn.wq", (L, d, H, Dh), "normal", s),
        (pre + "attn.wk", (L, d, K, Dh), "normal", s),
        (pre + "attn.wv", (L, d, K, Dh), "normal", s),
        (pre + "attn.wo", (L, H, Dh, d), "normal", (H * Dh) ** -0.5),
        (pre + "norm2.scale", (L, d), "ones", None),
        (pre + "mlp.w1", (L, d, f), "normal", s),
        (pre + "mlp.w2", (L, f, d), "normal", f ** -0.5),
        (pre + "mlp.w3", (L, d, f), "normal", s),
        ("final_norm.scale", (d,), "ones", None),
    ]
    if not c.get("tie_word_embeddings", False):
        out.append(("lm_head.w", (V, d), "normal", s))
    return out


def attention_heads(c: dict) -> tuple:
    """``(query heads, kv heads, head size)`` of the attention kernels."""
    return c["num_attention_heads"], c["num_key_value_heads"], c["head_dim"]


def body_flops(c: dict) -> int:
    """2 x the weights of every layer's products (q, k, v and o
    projections, the SwiGLU's three matrices): FLOPs a token."""
    d, H, K, Dh = (c["hidden_size"], c["num_attention_heads"],
                   c["num_key_value_heads"], c["head_dim"])
    L, f = c["num_hidden_layers"], c["intermediate_size"]
    return 2 * L * (d * (H + 2 * K) * Dh + H * Dh * d + 3 * d * f)


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
