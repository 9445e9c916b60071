"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where no CUDA device is present (the check
runs inside the fixture, never at import). On a machine with an H100:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances as on the CPU: 2e-5 for f32 (TF32 off), 2e-2 for bf16.
"""
import pytest
import torch

pytestmark = pytest.mark.cuda

CASES = [
    # B, Sq, Skv, H, Hkv, Dh, causal, window, q_offset
    (2, 256, 256, 4, 2, 16, True, 0, 0),
    (1, 200, 200, 2, 1, 64, False, 0, 0),
    (1, 96, 160, 8, 2, 128, True, 64, 64),
    (1, 64, 64, 2, 1, 32, True, 0, -16),
    (1, 128, 128, 2, 1, 256, True, 0, 0),
]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run on the card only)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _randn(gen, shape, dtype, dev):
    return torch.randn(shape, generator=gen).to(dev, dtype)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
def test_flash_kernel_vs_plain(dev, case, dtype, tol):
    from repro_torch.kernels import flash_attention, ops, ref
    B, Sq, Skv, H, Hkv, Dh, causal, window, q_offset = case
    gen = torch.Generator().manual_seed(0)
    q = _randn(gen, (B, Sq, H, Dh), dtype, dev)
    k, v = (_randn(gen, (B, Skv, Hkv, Dh), dtype, dev) for _ in range(2))
    before = flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = ref.mha(q, k, v, causal=causal, window=window, q_offset=q_offset)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
def test_decode_kernel_vs_plain(dev, dtype, tol):
    from repro_torch.kernels import decode_attention, ops, ref
    B, C, H, Hkv, Dh = 4, 300, 8, 2, 128
    gen = torch.Generator().manual_seed(1)
    q = _randn(gen, (B, H, Dh), dtype, dev)
    kc, vc = (_randn(gen, (B, C, Hkv, Dh), dtype, dev) for _ in range(2))
    cl = torch.tensor([0, 1, 300, 157], dtype=torch.int32, device=dev)
    before = decode_attention.launches
    got = ops.decode_attention(q, kc, vc, cl)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    assert torch.count_nonzero(got[0]) == 0
    torch.testing.assert_close(got.float(), ref.decode_attention(q, kc, vc, cl).float(),
                               atol=tol, rtol=tol)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    from repro_torch.kernels import decode_attention, flash_attention
    q = torch.zeros(1, 8, 2, 24, device=dev)  # Dh 24 is not a multiple of 16
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention.flash_attention_cuda(q, q[:, :, :1], q[:, :, :1], causal=True,
                                             window=0, q_offset=0, softmax_scale=1.0)
    q = torch.zeros(1, 2, 16, device=dev, dtype=torch.float16)
    kc = torch.zeros(1, 8, 1, 16, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        decode_attention.decode_attention_cuda(
            q, kc, kc, torch.ones(1, dtype=torch.int32, device=dev), softmax_scale=1.0)


def test_smoke_serve_goes_through_the_kernels(dev):
    from repro_torch.kernels import decode_attention, flash_attention, ref
    from repro_torch.launch import serve
    flash_attention.launches = decode_attention.launches = ref.calls = 0
    result = serve.main(["--arch", "qwen3-1.7b", "--smoke", "--requests", "4",
                         "--batch", "2", "--prompt-len", "32", "--gen-len", "3"])
    assert result["finite"]
    assert flash_attention.launches == 4 * 2
    assert decode_attention.launches == 4 * 2 * 3
    assert ref.calls == 0
