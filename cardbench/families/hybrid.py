"""The Mamba-2 and attention hybrid family (Granite 4.0-H's block), from a
configuration file's published widths: the leaves the benchmark draws
(the port's parameter tree), the keyword arguments of the port's
``ModelConfig`` with its ``ssm`` group, and the model FLOPs that
``mfu.*`` count.  Its reference math is ``reference/hybrid.py``.

``layer_types`` places the layers: ``attention`` (grouped-query
attention with no positions, softmax scale ``attention_multiplier``) or
``mamba`` (a Mamba-2 mixer of ``mamba_n_heads`` heads of
``mamba_d_head``, state ``mamba_d_state``, one group of B and C, a
causal conv of ``mamba_d_conv`` with a bias over ``[x, B, C]``, and a
gated RMSNorm before its output projection).  Every layer then has a
SwiGLU of ``shared_intermediate_size``.  The port places the attention
layers by a period and an offset, so the list must repeat with one
attention layer a period.  The muP scalars: the embedding times
``embedding_multiplier``, each sublayer's output times
``residual_multiplier`` before its residual add, the logits divided by
``logits_scaling``.

Keys are accounted for as in ``families/dense.py``: mapped, describing
the file, fixed to the one value this family runs, or listed under
``port_departures``; any other key, or a fixed one set otherwise, is
refused."""
from __future__ import annotations

import math

MAPPED = ("num_hidden_layers", "hidden_size", "num_attention_heads",
          "num_key_value_heads", "head_dim", "shared_intermediate_size",
          "vocab_size", "rms_norm_eps", "tie_word_embeddings", "layer_types",
          "mamba_n_heads", "mamba_d_head", "mamba_d_state", "mamba_expand",
          "mamba_d_conv", "mamba_chunk_size", "embedding_multiplier",
          "residual_multiplier", "attention_multiplier", "logits_scaling")
#: options this family's port mapping and reference run one way only
FIXED = {"hidden_act": "silu", "attention_bias": False,
         "mamba_conv_bias": True, "mamba_proj_bias": False,
         "mamba_n_groups": 1, "position_embedding_type": "nope",
         "normalization_function": "rmsnorm", "num_local_experts": 0,
         "num_experts_per_tok": 0, "rope_scaling": None}
#: ``intermediate_size`` is the routed experts' width, which no layer has
#: (``num_local_experts`` 0); ``rope_theta`` is unused without positions
ABOUT = ("name", "family", "source", "reduced", "assumed",
         "port_departures", "dtypes", "max_position_embeddings",
         "model_type", "intermediate_size", "rope_theta")
KINDS = ("mamba", "attention")


def schedule(c: dict) -> tuple:
    """``(attn_every, attn_offset)`` of ``layer_types``: the shortest
    period that repeats the list, with its one attention layer's place
    in it (``(0, 0)`` for a list without attention).  Raises for a list
    that is not so."""
    types = list(c["layer_types"])
    if len(types) != c["num_hidden_layers"] or set(types) - set(KINDS):
        raise ValueError(
            f"{c.get('name')}, hybrid family: layer_types must give "
            f"num_hidden_layers entries of {KINDS}")
    if "attention" not in types:
        return 0, 0
    n = len(types)
    period = next(p for p in range(1, n + 1) if n % p == 0
                  and all(types[i] == types[i % p] for i in range(n)))
    attn = [i for i in range(period) if types[i] == "attention"]
    if len(attn) != 1:
        raise ValueError(
            f"{c.get('name')}, hybrid family: layer_types is not periodic "
            "with one attention layer a period, which is what the port "
            "places (attn_every, attn_offset). Such a model needs a "
            "family file of its own.")
    return period, attn[0]


def check(c: dict) -> None:
    """Raise unless every key of the file is one this family accounts
    for, every fixed option is stated with the value the family runs,
    the Mamba-2 heads fill the inner width, and ``layer_types`` repeats
    with one attention layer a period."""
    departs = set(c.get("port_departures", {}))
    unknown = sorted(k for k in c if k not in MAPPED and k not in FIXED
                     and k not in ABOUT and k not in departs)
    wrong = sorted(k for k, v in FIXED.items() if c.get(k) != v)
    missing = sorted(k for k in MAPPED if k not in c
                     and k != "tie_word_embeddings")
    problems = [f"keys it does not map {unknown}" if unknown else "",
                f"{wrong} not stated as {FIXED}" if wrong else "",
                f"no {missing}" if missing else ""]
    if not missing and c["mamba_n_heads"] * c["mamba_d_head"] != \
            c["mamba_expand"] * c["hidden_size"]:
        problems.append("mamba_n_heads x mamba_d_head is not mamba_expand "
                        "x hidden_size")
    if any(problems):
        raise ValueError(
            f"{c.get('name')}, hybrid family: "
            + "; ".join(p for p in problems if p)
            + ". Such a model needs a family file of its own.")
    schedule(c)


def vocab(c: dict) -> int:
    return c["vocab_size"]


def port_kwargs(c: dict) -> dict:
    """The port's ``ModelConfig`` fields (without the dtypes); ``ssm`` is
    the port's ``SSMConfig`` as a dict."""
    check(c)
    every, offset = schedule(c)
    return dict(
        name=c["name"], family="hybrid", source=c["source"],
        num_layers=c["num_hidden_layers"], d_model=c["hidden_size"],
        num_heads=c["num_attention_heads"],
        num_kv_heads=c["num_key_value_heads"], head_dim=c["head_dim"],
        d_ff=c["shared_intermediate_size"], vocab_size=c["vocab_size"],
        norm_eps=float(c["rms_norm_eps"]),
        tie_embeddings=bool(c.get("tie_word_embeddings", False)),
        qkv_bias=False, mlp_type="swiglu", sliding_window=None,
        pos_embedding="none", attn_every=every, attn_offset=offset,
        ssm=dict(state=c["mamba_d_state"], head_dim=c["mamba_d_head"],
                 expand=c["mamba_expand"], conv_width=c["mamba_d_conv"],
                 chunk=c["mamba_chunk_size"]),
        embedding_multiplier=float(c["embedding_multiplier"]),
        residual_multiplier=float(c["residual_multiplier"]),
        attention_multiplier=float(c["attention_multiplier"]),
        logits_scaling=float(c["logits_scaling"]))


def _a_log(u):
    """A = -exp(A_log) uniform on [1, 16], as Mamba-2 initialises it."""
    return u.mul(15).add(1).log()


def _dt_bias(u):
    """softplus(dt_bias) log-uniform on [1e-3, 1e-1], as Mamba-2
    initialises it (the inverse softplus of the draw)."""
    dt = (u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3)).exp()
    return dt + (-(-dt).expm1()).log()


def leaves(c: dict) -> list:
    """``[(path, shape, init, scale)]``: the period's sublayers, each leaf
    stacked on dim 0 over the periods (``layers.<i>.`` the i-th layer of
    a period).  The embedding is drawn at ``hidden_size ** -0.5 /
    embedding_multiplier``, as muP draws it small for its multiplier to
    scale up: at ``hidden_size ** -0.5`` the tied head's product of a
    token's row with itself (12 x its square norm) would outweigh every
    other logit, and every served token would repeat the last one."""
    d, H, K = c["hidden_size"], c["num_attention_heads"], \
        c["num_key_value_heads"]
    Dh, f, V, L = c["head_dim"], c["shared_intermediate_size"], \
        c["vocab_size"], c["num_hidden_layers"]
    Hs, P, N, W = c["mamba_n_heads"], c["mamba_d_head"], \
        c["mamba_d_state"], c["mamba_d_conv"]
    di, conv = Hs * P, Hs * P + 2 * N
    every, offset = schedule(c)
    period = every or 1
    G = L // period
    s = d ** -0.5
    out = [("embed.tok", (V, d), "normal", s / c["embedding_multiplier"])]
    for i in range(period):
        pre = f"layers.{i}."
        out.append((pre + "norm1.scale", (G, d), "ones", None))
        if every and i == offset:
            out += [
                (pre + "attn.wq", (G, d, H, Dh), "normal", s),
                (pre + "attn.wk", (G, d, K, Dh), "normal", s),
                (pre + "attn.wv", (G, d, K, Dh), "normal", s),
                (pre + "attn.wo", (G, H, Dh, d), "normal", (H * Dh) ** -0.5),
            ]
        else:
            out += [
                (pre + "ssm.wz", (G, d, di), "normal", s),
                (pre + "ssm.wx", (G, d, di), "normal", s),
                (pre + "ssm.wB", (G, d, N), "normal", s),
                (pre + "ssm.wC", (G, d, N), "normal", s),
                (pre + "ssm.wdt", (G, d, Hs), "normal", s),
                (pre + "ssm.conv_w", (G, W, conv), "normal", W ** -0.5),
                (pre + "ssm.conv_b", (G, conv), "normal", 0.1),
                (pre + "ssm.A_log", (G, Hs), "rand", _a_log),
                (pre + "ssm.D", (G, Hs), "ones", None),
                (pre + "ssm.dt_bias", (G, Hs), "rand", _dt_bias),
                (pre + "ssm.norm_scale", (G, di), "ones", None),
                (pre + "ssm.wo", (G, di, d), "normal", di ** -0.5),
            ]
        out += [
            (pre + "norm2.scale", (G, d), "ones", None),
            (pre + "mlp.w1", (G, d, f), "normal", s),
            (pre + "mlp.w2", (G, f, d), "normal", f ** -0.5),
            (pre + "mlp.w3", (G, d, f), "normal", s),
        ]
    out.append(("final_norm.scale", (d,), "ones", None))
    if not c.get("tie_word_embeddings", False):
        out.append(("lm_head.w", (V, d), "normal", s))
    return out


def attention_heads(c: dict) -> tuple:
    """``(query heads, kv heads, head size)`` of the attention kernels."""
    return c["num_attention_heads"], c["num_key_value_heads"], c["head_dim"]


def layer_counts(c: dict) -> tuple:
    """``(attention layers, Mamba-2 layers)``."""
    n = c["layer_types"].count("attention")
    return n, c["num_hidden_layers"] - n


def ssm_shape(c: dict) -> tuple:
    """``(heads, head size, state)`` of a Mamba-2 layer."""
    return c["mamba_n_heads"], c["mamba_d_head"], c["mamba_d_state"]


def body_flops(c: dict) -> int:
    """FLOPs a token: 2 x the weights of every layer's products (the
    attention layers' q, k, v and o projections; the Mamba-2 layers' in
    and out projections; every layer's SwiGLU), plus each Mamba-2 layer's
    recurrent step, 6 x heads x head size x state (the state's decay and
    input, its product with C), and its conv, 2 x width x channels."""
    d, H, K, Dh = (c["hidden_size"], c["num_attention_heads"],
                   c["num_key_value_heads"], c["head_dim"])
    f = c["shared_intermediate_size"]
    Hs, P, N = ssm_shape(c)
    di, conv = Hs * P, Hs * P + 2 * N
    n_attn, n_ssm = layer_counts(c)
    attn = d * (H + 2 * K) * Dh + H * Dh * d
    ssm = d * (2 * di + 2 * N + Hs) + di * d
    mlp = 3 * d * f
    return (2 * (n_attn * attn + n_ssm * ssm
                 + c["num_hidden_layers"] * mlp)
            + n_ssm * (6 * Hs * P * N + 2 * c["mamba_d_conv"] * conv))


def head_flops(c: dict) -> int:
    """The output head: FLOPs a token whose logits are made."""
    return 2 * c["hidden_size"] * c["vocab_size"]


def pair_flops(c: dict) -> int:
    """Attention of one query over one key line: 4 x heads x head size in
    each attention layer (q.k and p.v)."""
    return 4 * layer_counts(c)[0] * c["num_attention_heads"] * c["head_dim"]


def chunk_pair_flops(c: dict, n: int) -> int:
    """The Mamba-2 layers' work in a prefill of ``n`` tokens beyond the
    recurrent step that :func:`body_flops` counts a token: the chunked
    form's products over the causal pairs inside each chunk of
    ``mamba_chunk_size``, C.B once (2 x state a pair) and the weighted x
    in every head (2 x heads x head size a pair)."""
    Q = c["mamba_chunk_size"]
    Hs, P, N = ssm_shape(c)
    full, rest = divmod(n, Q)
    pairs = full * Q * (Q + 1) // 2 + rest * (rest + 1) // 2
    return layer_counts(c)[1] * pairs * (2 * N + 2 * Hs * P)


def mixer_flops(c: dict, n: int, start: int) -> int:
    """Attention of ``n`` new tokens after ``start`` cached ones, causal
    among the new, and the Mamba-2 layers' chunk pairs of the ``n``."""
    return pair_flops(c) * (n * start + n * (n + 1) // 2) \
        + chunk_pair_flops(c, n)
