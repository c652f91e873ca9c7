"""The port's CUDA kernels against their plain PyTorch versions, on the card.

CUDA kernels have no CPU mode, so every test here is marked ``cuda`` and
skips where no card is present. On the H100:

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -o addopts=""

(``--noconftest``: the suite's conftest.py sets up JAX, which that machine
does not have; ``-o addopts=""`` drops the suite's xdist options.)

The shapes are small and ragged on purpose (N not a multiple of the column
tile, odd M, GQA, head_dim 64); chip_smoke.py covers the Llama-7B shapes.
"""

import pytest
import torch

from exllama_tpu_torch.formats.gptq import QuantTensor
from exllama_tpu_torch.ops import attention, dense, quant

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.Generator(device="cuda").manual_seed(0)


def _qt(gen, k, n, gs, act_order):
    words = torch.randint(-(2 ** 31), 2 ** 31 - 1, (k // 8, n), generator=gen,
                          device="cuda", dtype=torch.int64).to(torch.int32)
    s = torch.rand((k // gs, n), generator=gen, device="cuda") * 0.01 + 0.002
    z = s * torch.randint(1, 16, s.shape, generator=gen, device="cuda")
    xm = (torch.randperm(k, generator=gen, device="cuda").to(torch.int32)
          if act_order else None)
    return QuantTensor(words, s.bfloat16(), z.bfloat16(), xm, gs)


def _close(got, ref, rel):
    got, ref = got.float(), ref.float()
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max() <= rel * ref.abs().max()


@pytest.mark.parametrize("m,k,n,gs,act,norm", [
    (1, 256, 520, 32, False, True),
    (3, 512, 200, 64, True, False),
    (7, 1024, 1000, 128, True, True),
    (32, 768, 96, 128, False, False),
])
def test_q4_gemv_matches_plain(gen, m, k, n, gs, act, norm):
    """1e-2 of the output scale: f32 group sums of exact nibbles vs a
    product of bf16-rounded weights, both rounded to bf16."""
    qt = _qt(gen, k, n, gs, act)
    x = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
    nw = (torch.rand(k, generator=gen, device="cuda") + 0.5).bfloat16() \
        if norm else None
    before = quant.q4_gemv.launches
    got = quant.q4_gemv(x, qt, nw, 1e-5)
    assert quant.q4_gemv.launches == before + 1
    _close(got, quant.q4_gemv_plain(x, qt, nw, 1e-5), 1e-2)


@pytest.mark.parametrize("m,k,n,gs", [
    (33, 256, 520, 32), (130, 512, 136, 64), (257, 1024, 384, 128),
])
def test_q4_dequant_matmul_matches_plain(gen, m, k, n, gs):
    """1e-2: the same bf16 weights, f32 sums in another order, bf16 out."""
    qt = _qt(gen, k, n, gs, False)
    x = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
    _close(quant.q4_dequant_matmul(x, qt),
           quant._q4_matmul_plain(x, qt), 1e-2)


@pytest.mark.parametrize("b,t,h,hkv,d,past,deferred,masked", [
    (2, 1, 8, 2, 64, 70, True, False),
    (1, 1, 4, 4, 128, 0, True, False),
    (2, 37, 8, 2, 64, [5, 40], False, False),
    (2, 19, 4, 1, 128, 0, False, True),
    (1, 130, 4, 4, 64, 3, False, False),
])
def test_flash_attn_matches_plain(gen, b, t, h, hkv, d, past, deferred,
                                  masked):
    """2e-2: p is rounded to bf16 against a running max in the kernel and
    against the final max in the plain version."""
    s_max = 256
    q = torch.randn((b, t, h, d), generator=gen, device="cuda").bfloat16()
    kc = torch.randn((b, hkv, s_max, d), generator=gen,
                     device="cuda").bfloat16()
    vc = torch.randn_like(kc)
    past_t = (past if isinstance(past, int)
              else torch.tensor(past, dtype=torch.int32, device="cuda"))
    new_kv = None
    if deferred:
        new_kv = tuple(torch.randn((b, 1, hkv, d), generator=gen,
                                   device="cuda").bfloat16()
                       for _ in range(2))
    mask = None
    if masked:
        mask = torch.ones((b, s_max), dtype=torch.bool, device="cuda")
        mask[0, :6] = False
    got = attention.attend(q, kc, vc, past_t, 192, mask, new_kv)
    ref = attention.attend_plain(q, kc, vc, past_t, 192, mask, new_kv)
    _close(got, ref, 2e-2)
    if masked:        # rows with no visible key come out exactly 0
        assert (got[0, :6] == 0).all()


@pytest.mark.parametrize("m,k,v", [(1, 256, 1000), (5, 512, 130),
                                   (32, 128, 64)])
def test_dense_gemv_matches_plain(gen, m, k, v):
    """1e-4: f32 output of the same bf16 inputs, sums in another order."""
    x = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
    w = torch.randn((k, v), generator=gen, device="cuda").bfloat16()
    _close(dense.dense_gemv(x, w), dense.dense_gemv_plain(x, w), 1e-4)
