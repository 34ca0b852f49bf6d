"""The traffic generator: the same seed gives the same traffic, and every
seed the same sizes in another order."""
import numpy as np
import pytest

from harness import mix, spec
from tiny import OPEN_LOOP

BIG = 2**31 + 12345
SERVE = [w["traffic"] for w in spec.benchmark()["workloads"]
         if spec.resolve(w["name"]).traffic["kind"] == "serve"] \
    + ["open_loop"]
TRAIN = [w["traffic"] for w in spec.benchmark()["workloads"]
         if spec.resolve(w["name"]).traffic["kind"] == "train"]


def load(name):
    if name == "open_loop":
        return OPEN_LOOP
    return spec.load_json(spec.HERE / "traffic" / f"{name}.json")


def take(stream, n):
    return [stream.next() for _ in range(n)]


@pytest.mark.parametrize("name", SERVE)
def test_serve_stream_is_a_function_of_the_seed(name):
    m = load(name)
    a = take(mix.ServeStream(m, 50304, BIG), 300)
    b = take(mix.ServeStream(m, 50304, BIG), 300)
    for x, y in zip(a, b):
        assert np.array_equal(x.prompt, y.prompt)
        assert (x.max_new, x.due, x.prefix) == (y.max_new, y.due, y.prefix)
    c = take(mix.ServeStream(m, 50304, BIG + 1), 300)
    assert any(not np.array_equal(x.prompt, y.prompt) for x, y in zip(a, c))


@pytest.mark.parametrize("name", SERVE)
def test_every_seed_has_the_same_schedule(name):
    m = load(name)
    block = m.get("block", 128)

    def schedule(seed):
        s = mix.ServeStream(m, 50304, seed)
        reqs = take(s, 3 * block)
        return ([len(r.prompt) for r in reqs], [r.max_new for r in reqs],
                [r.due for r in reqs], [r.prefix for r in reqs],
                [(len(r.prompt), r.max_new) for r in s.warm()])

    assert schedule(BIG) == schedule(7) == schedule(2**40 + 3)
    # each block holds the grid's sizes, in another order
    one = schedule(BIG)
    assert sorted(one[0][:block]) == sorted(one[0][block:2 * block])
    assert one[0][:block] != one[0][block:2 * block]
    reqs = take(mix.ServeStream(m, 50304, BIG), block)
    lens, outs = [len(r.prompt) for r in reqs], [r.max_new for r in reqs]
    user = m["prompt"]
    pre = m["prefixes"]["length"] if "prefixes" in m else 0
    assert min(lens) >= user["min"] + pre and max(lens) <= user["max"] + pre
    assert m["output"]["min"] <= min(outs) and max(outs) <= m["output"]["max"]
    cache = m["engine"]["cache_len"]
    assert max(lens) + m["output"]["max"] < cache


@pytest.mark.parametrize("name", SERVE)
def test_warm_start_fills_every_client(name):
    m = load(name)
    warm = mix.ServeStream(m, 50304, BIG).warm()
    if m.get("warm_start") != "remaining_life":
        assert warm == []
        return
    assert len(warm) == m["clients"]
    lo, hi = m["output"]["min"], m["output"]["max"]
    for r in warm:
        assert 1 <= r.max_new <= hi
        assert len(r.prompt) + r.max_new <= m["prompt"]["max"] + hi
        assert len(r.prompt) + r.max_new < m["engine"]["cache_len"]
    # length-biased: in flight, long requests outnumber short ones
    total = [len(r.prompt) + r.max_new for r in warm]
    assert np.mean([r.max_new for r in warm]) < (lo + hi) / 2
    assert len(set(total)) > 1


def test_shared_prefix_popularity_is_zipf():
    m = load("open_loop")
    reqs = take(mix.ServeStream(m, 50304, BIG), 640)
    counts = np.bincount([r.prefix for r in reqs], minlength=8)
    assert counts[0] > counts[1] > counts[7] > 0
    gaps = np.diff([0.0] + [r.due for r in reqs])
    assert abs(gaps.mean() * m["rate"] - 1) < 0.05


@pytest.mark.parametrize("name", TRAIN)
def test_train_rows(name):
    m = load(name)
    a = mix.train_batch(m, 50288, BIG, 1)
    b = mix.train_batch(m, 50288, BIG, 1)
    c = mix.train_batch(m, 50288, BIG, 2)
    for k in a:
        assert np.array_equal(a[k], b[k])
    assert a["tokens"].shape == (m["batch"], m["seq_len"])
    assert np.array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert np.array_equal(a["loss_mask"], (a["tokens"] != mix.EOS))
    rows = {r.tobytes() for r in np.concatenate([a["tokens"], c["tokens"]])}
    assert len(rows) == 2 * m["batch"]
    assert (a["tokens"] == mix.EOS).sum() >= 1


def test_quantiles():
    q = (np.arange(1000) + 0.5) / 1000
    u = mix.quantile({"dist": "uniform", "min": 16, "max": 64}, q)
    assert u.min() == 16 and u.max() == 64
    lu = mix.quantile({"dist": "loguniform", "min": 64, "max": 512}, q)
    assert lu.min() == 64 and lu.max() == 512
    assert np.median(lu) == pytest.approx(np.sqrt(64 * 513), rel=0.02)
    lx = mix.quantile({"dist": "lomax", "mean": 512}, q)
    assert lx.min() >= 8 and lx.max() <= 2048
    e = mix.quantile({"dist": "exponential", "mean": 0.1}, q)
    assert e.mean() == pytest.approx(0.1, rel=0.02)
    assert list(mix.weighted_counts(np.array([3.0, 1.0]), 8)) == [6, 2]
