"""The reference against the port's plain route at reduced sizes: the
dense model's prefill and then paged decode (logits), and its loss and
gradients, from the same weights; and the port's model as the family
file maps it."""
import numpy as np
import pytest
import torch

from harness import port, weights
from reference import dense
from tiny import tiny

SEED = 2**31 + 202


def f32_port(workload):
    cell = tiny(workload)
    conf = cell.config
    cfg = port.model_config(conf, "float32", "float32")
    flat = weights.make(conf, SEED, "cpu", torch.float32)
    port.check_layout(cfg, flat)
    return cell, conf, cfg, flat


def test_dense_prefill_then_paged_decode(one_thread):
    from repro_torch.configs.base import RunConfig
    from repro_torch.models.model import decode_step, init_cache, prefill
    from repro_torch.models.paging import PagedKVConfig

    _, conf, cfg, flat = f32_port("stablelm-3b.decode")
    params = weights.tree(flat)
    run = RunConfig(use_kernels=False)
    rng = np.random.default_rng(0)
    P, n = 21, 6
    toks = torch.from_numpy(rng.integers(2, conf["vocab_size"], P + n))
    logits, cache1 = prefill(params, {"tokens": toks[None, :P]}, cfg, run)
    want = dense.logits(flat, conf, toks, P - 1)
    assert torch.allclose(logits[0, -1], want[0], atol=1e-4, rtol=1e-4)
    # the prompt's lines into a paged pool (pages 1..), then decode
    ps, pages = 16, 4
    cache = init_cache(cfg, 1, ps * pages, paging=PagedKVConfig(
        page_size=ps, num_pages=pages + 1, pages_per_seq=pages))
    table = torch.arange(1, pages + 1, dtype=torch.int32)[None]
    for lay, new in zip(cache["layers"], cache1["layers"]):
        for k in ("k", "v"):
            for pos in range(P):
                lay[k][:, 1 + pos // ps, pos % ps] = new[k][:, 0, pos]
    for j in range(n):
        pos = P + j
        out, cache = decode_step(params, cache, toks[None, pos:pos + 1],
                                 torch.tensor([pos]), cfg, run,
                                 page_table=table)
        # the pool holds bfloat16 lines: one rounding of k and v
        assert torch.allclose(out[0, 0], want[j + 1], atol=3e-2, rtol=0)
        assert out[0, 0].argmax() == want[j + 1].argmax() or \
            (want[j + 1].max() - want[j + 1][out[0, 0].argmax()]) < 3e-2


def test_the_port_builds_what_the_file_states():
    """Every option the dense family runs one way is set so in the port's
    model, and the widths are the file's."""
    conf = tiny("stablelm-3b.decode").config
    cfg = port.model_config(conf, "bfloat16", "float32")
    assert (cfg.qkv_bias, cfg.mlp_type, cfg.sliding_window) == \
        (False, "swiglu", None)
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size) == (
        conf["num_hidden_layers"], conf["hidden_size"],
        conf["num_attention_heads"], conf["num_key_value_heads"],
        conf["head_dim"], conf["intermediate_size"], conf["vocab_size"])
    assert (cfg.dtype, cfg.param_dtype) == ("bfloat16", "float32")


def test_dense_loss_and_gradients(one_thread):
    from repro_torch.configs.base import RunConfig
    from repro_torch.models.model import loss_fn
    from harness import mix as mixmod

    cell, conf, cfg, flat = f32_port("stablelm-3b.decode")
    mix = {"batch": 2, "seq_len": 48, "block": 8,
           "docs": {"dist": "lomax", "mean": 16}}
    b = {k: torch.from_numpy(v) for k, v in mixmod.train_batch(
        mix, conf["vocab_size"], SEED, 1).items()}
    xs = {k: v.clone().requires_grad_(True) for k, v in flat.items()}
    loss, _ = loss_fn(weights.tree(xs), b, cfg, RunConfig(use_kernels=False,
                                                          remat="none"))
    grads = torch.autograd.grad(loss, list(xs.values()))
    W = {k: v.clone().requires_grad_(True) for k, v in flat.items()}
    ref = dense.loss_sum(W, conf, b["tokens"].long(), b["labels"].long(),
                         b["loss_mask"]) / b["loss_mask"].sum()
    rgrads = torch.autograd.grad(ref, list(W.values()))
    assert float(loss.detach()) == pytest.approx(float(ref.detach()), rel=1e-5)
    for k, g, r in zip(flat, grads, rgrads):
        assert torch.allclose(g, r, atol=1e-6 + 1e-4 * float(r.abs().max()),
                              rtol=1e-3), k


def test_weights_are_a_function_of_the_seed():
    conf = tiny("stablelm-3b.decode").config
    a = weights.make(conf, SEED, "cpu", torch.bfloat16)
    b = weights.make(conf, SEED, "cpu", torch.bfloat16)
    c = weights.make(conf, SEED + 1, "cpu", torch.bfloat16)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed.tok"], c["embed.tok"])
    assert a["layers.0.attn.wq"].dtype == torch.bfloat16
    assert a["final_norm.scale"].dtype == torch.float32
    std = float(a["layers.0.mlp.w1"].float().std())
    assert std == pytest.approx(conf["hidden_size"] ** -0.5, rel=0.1)


@pytest.mark.parametrize("break_it", ["drop_leaf", "wrong_shape",
                                      "extra_leaf"])
def test_a_layout_that_is_not_the_ports_is_refused(break_it):
    conf = tiny("stablelm-3b.decode").config
    cfg = port.model_config(conf, "float32", "float32")
    flat = weights.make(conf, SEED, "cpu", torch.float32)
    port.check_layout(cfg, flat)
    if break_it == "drop_leaf":
        flat.pop("layers.0.mlp.w3")
    elif break_it == "wrong_shape":
        flat["layers.0.attn.wq"] = flat["layers.0.attn.wq"][:, :, :2]
    else:
        flat["layers.0.attn.bq"] = torch.zeros(2, 4, 16)
    with pytest.raises(RuntimeError, match="not the port's parameter tree"):
        port.check_layout(cfg, flat)


def test_a_leaf_of_special_init_is_drawn_from_the_seed(monkeypatch):
    """A family may give a leaf a ``rand`` init: a map of one uniform
    draw, made from the seed like the matrices."""
    conf = tiny("stablelm-3b.decode").config
    base = weights.layout(conf)
    extra = base + [("layers.0.decay", (2, 4), "rand",
                     lambda u: u.mul(15).add(1).log())]
    monkeypatch.setattr(weights, "layout", lambda c: extra)
    a = weights.make(conf, SEED, "cpu", torch.bfloat16)
    b = weights.make(conf, SEED, "cpu", torch.bfloat16)
    d = a["layers.0.decay"]
    assert d.dtype == torch.float32 and torch.equal(d, b["layers.0.decay"])
    assert float(d.min()) >= 0.0 and float(d.max()) <= np.log(16.0)
    # the matrices are drawn as before the leaf was added
    monkeypatch.setattr(weights, "layout", lambda c: base)
    c = weights.make(conf, SEED, "cpu", torch.bfloat16)
    assert torch.equal(a["lm_head.w"], c["lm_head.w"])


def test_a_nested_group_becomes_the_ports_config_of_its_name(monkeypatch):
    """A family file maps a group of widths (``ssm``, ``moe``) as a dict;
    the port gets its config object of that name."""
    import types

    from repro_torch.configs.base import SSMConfig

    conf = tiny("stablelm-3b.decode").config
    fam = port.family(conf)
    kw = dict(fam.port_kwargs(conf), family="ssm", attn_every=0,
              ssm={"state": 16, "head_dim": 16, "expand": 2,
                   "conv_width": 4, "chunk": 32})
    monkeypatch.setattr(port, "family", lambda c: types.SimpleNamespace(
        port_kwargs=lambda c: kw))
    cfg = port.model_config(conf, "bfloat16", "float32")
    assert cfg.ssm == SSMConfig(state=16, head_dim=16, expand=2,
                                conv_width=4, chunk=32)
    assert cfg.layer_kinds() == ["ssm"] * conf["num_hidden_layers"]
