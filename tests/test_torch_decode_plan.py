"""The decode kernel's split plan (``flash_decode.split_plan``) and
the wrappers' refusals of what the 16-byte-copy kernels do not take, on
the CPU: no card, no build."""
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels import ops as tops

PLAN_CASES = [
    # (slots, batch, kv heads, SMs)
    (512, 4, 32, 132),       # stablelm-3b serving: the main path
    (4096, 4, 32, 132),
    (4096, 1, 32, 132),
    (256, 3, 4, 132),        # qwen2-7b GQA
    (64, 3, 32, 132),        # a 64-slot ring
    (1, 1, 1, 132),
    (33, 2, 2, 8),
    (100_000, 1, 1, 132),
    (4096, 64, 32, 132),     # more blocks than the aim without splitting
    (96, 1, 1, 1),
]


@pytest.mark.parametrize("slots,batch,kv_heads,sms", PLAN_CASES)
def test_split_plan_covers_every_line_once(slots, batch, kv_heads, sms):
    chunk, n = tfd.split_plan(slots, batch, kv_heads, sms)
    assert chunk % tfd.TILE == 0 and chunk >= tfd.TILE
    runs = [range(i * chunk, min((i + 1) * chunk, slots)) for i in range(n)]
    covered = [j for r in runs for j in r]
    assert covered == list(range(slots))          # once each, in order
    assert all(len(r) > 0 for r in runs)          # the last may be short
    # shapes alone decide it: the same shapes give the same plan
    assert tfd.split_plan(slots, batch, kv_heads, sms) == (chunk, n)


@pytest.mark.parametrize("slots,batch,kv_heads,sms", PLAN_CASES)
def test_split_plan_fills_the_card(slots, batch, kv_heads, sms):
    """At least half the aim of BLOCKS_PER_SM blocks per SM unless the
    splits are already one tile long, and no more splits than the aim
    needs."""
    chunk, n = tfd.split_plan(slots, batch, kv_heads, sms)
    aim = tfd.BLOCKS_PER_SM * sms
    assert 2 * n * batch * kv_heads >= aim or chunk == tfd.TILE or n == 1
    assert (n - 1) * batch * kv_heads < aim


def test_split_plan_at_the_main_path_shape():
    """q (4, 1, 32, 80) over a (4, 512, 32, 80) cache on 132 SMs: 4 splits
    of 128 lines, 512 blocks (~4 per SM) where one block per (sequence,
    kv head) gave 128; one sequence of 4096 lines: 16 splits of 256."""
    assert tfd.split_plan(512, 4, 32, 132) == (128, 4)
    assert tfd.split_plan(4096, 1, 32, 132) == (256, 16)


def test_split_plan_refuses_empty_shapes():
    with pytest.raises(ValueError, match="must be >= 1"):
        tfd.split_plan(0, 4, 32, 132)


class _FakeCuda:
    """A CPU tensor (real storage, so a real data pointer) that reports a
    CUDA device, so the wrappers' checks run without a card."""

    def __init__(self, t):
        self._t = t
        self.device = torch.device("cuda", 0)

    def __getattr__(self, name):
        return getattr(self._t, name)


def _decode_inputs(k_view, dtype=torch.bfloat16):
    B, _, K, Dh = k_view.shape
    q = torch.zeros(B, 1, 2 * K, Dh, dtype=dtype)
    pos = torch.zeros(B, dtype=torch.int32)
    return [_FakeCuda(t) for t in (q, k_view, k_view, pos)]


@pytest.mark.parametrize("make,what", [
    # one element off the base of the storage: base pointer misaligned
    (lambda: torch.zeros(2, 64, 4, 81, dtype=torch.bfloat16)[..., 1:],
     "base % 16 = 2"),
    # head_dim 20 in bf16: 40-byte lines, strides not multiples of 16
    (lambda: torch.zeros(2, 64, 4, 20, dtype=torch.bfloat16),
     "strides \\(5120, 80, 20, 1\\)"),
    # a cache of f32 with head_dim 6: 24-byte heads
    (lambda: torch.zeros(2, 64, 4, 6, dtype=torch.float32),
     "strides \\(1536, 24, 6, 1\\)"),
], ids=["base", "bf16-dh20", "f32-dh6"])
def test_decode_refuses_misaligned_caches(make, what):
    k = make()
    q, kc, vc, pos = _decode_inputs(k, dtype=k.dtype)
    before = tops.launch_counts()
    with pytest.raises(ValueError, match="16-byte aligned") as err:
        tfd.flash_decode_bshd(q, kc, vc, pos)
    assert what.replace("\\", "") in str(err.value)
    assert tops.launch_counts() == before


@pytest.mark.parametrize("make,what", [
    (lambda: torch.zeros(9, 16, 4, 81, dtype=torch.bfloat16)[..., 1:],
     "base % 16 = 2"),
    (lambda: torch.zeros(9, 16, 4, 20, dtype=torch.bfloat16),
     "strides \\(1280, 80, 20, 1\\)"),
], ids=["base", "bf16-dh20"])
def test_paged_decode_refuses_misaligned_pools(make, what):
    """The paged launch copies pool lines with 16-byte copies as the dense
    one does, so it refuses the same layouts, before any build or launch
    count."""
    pool = make()
    K, Dh = pool.shape[2], pool.shape[3]
    q = _FakeCuda(torch.zeros(2, 1, 2 * K, Dh, dtype=pool.dtype))
    kp = _FakeCuda(pool)
    table = _FakeCuda(torch.ones(2, 4, dtype=torch.int32))
    pos = _FakeCuda(torch.zeros(2, dtype=torch.int32))
    before = tops.launch_counts()
    with pytest.raises(ValueError, match="16-byte aligned") as err:
        tfd.flash_decode_paged_bshd(q, kp, kp, table, pos)
    assert what.replace("\\", "") in str(err.value)
    assert tops.launch_counts() == before


def test_decode_takes_a_padded_line():
    """head_dim 20 inside 24-element lines: 16-byte strides, so the
    alignment check passes (the wrapper then needs a card)."""
    k = torch.zeros(2, 64, 4, 24, dtype=torch.bfloat16)[..., :20]
    build.check_aligned("flash_decode", "k", k)


@pytest.mark.parametrize("name", ["q", "k", "v"])
def test_attention_refuses_misaligned_bf16(name):
    ts = {n: torch.zeros(1, 16, 4, 64, dtype=torch.bfloat16)
          for n in "qkv"}
    ts[name] = torch.zeros(1, 16, 4, 65, dtype=torch.bfloat16)[..., 1:]
    with pytest.raises(ValueError, match=f"{name} must be 16-byte aligned"):
        tfa._check(*(_FakeCuda(ts[n]) for n in "qkv"))


def test_attention_f32_needs_no_alignment():
    """The f32 kernel reads with scalar loads: any strides pass."""
    q, k, v = (torch.zeros(1, 16, 4, 65)[..., 1:] for _ in range(3))
    tfa._check(*(_FakeCuda(t) for t in (q, k, v)))


def test_refusals_come_after_the_device_check():
    """A misaligned CPU tensor is refused for its device first."""
    k = torch.zeros(1, 8, 2, 65, dtype=torch.bfloat16)[..., 1:]
    q = torch.zeros(1, 1, 2, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfd.flash_decode_bshd(q, k, k, torch.zeros(1, dtype=torch.int32))
