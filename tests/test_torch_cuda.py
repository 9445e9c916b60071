"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where no CUDA device is present (the check
runs inside the fixture, never at import). On a machine with an H100:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances as on the CPU: attention 2e-5 for f32 (TF32 off), 2e-2 for bf16;
the RG-LRU scan 1e-4 / 3e-2; the SSD scan 5e-4 against the sequential oracle
(2e-2 on bf16 y, which the oracle rounds only at its output).
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


@pytest.mark.parametrize("B,C,H,Dh,lens", [(4, 2048, 16, 256, (2048, 2048, 1000, 0)),
                                             (2, 300, 12, 64, (300, 5))])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
def test_decode_kernel_large_group_vs_plain(dev, B, C, H, Dh, lens, dtype, tol):
    """Group 16 at head_dim 256 (recurrentgemma-9b's MQA) and group 12 (a full
    and a partial slice of 8 query heads)."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator().manual_seed(2)
    q = _randn(gen, (B, H, Dh), dtype, dev)
    kc, vc = (_randn(gen, (B, C, 1, Dh), dtype, dev) for _ in range(2))
    cl = torch.tensor(lens, dtype=torch.int32, device=dev)
    got = ops.decode_attention(q, kc, vc, cl)
    torch.testing.assert_close(got.float(), ref.decode_attention(q, kc, vc, cl).float(),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("B,S,H,P,N,chunk,with_h0", [(2, 300, 8, 64, 128, 256, True),
                                                     (2, 37, 3, 8, 16, 8, True),
                                                     (1, 512, 4, 64, 128, 256, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_vs_oracle(dev, B, S, H, P, N, chunk, with_h0, dtype):
    from repro_torch.kernels import ops, ref, ssd_scan
    gen = torch.Generator().manual_seed(3)
    x = _randn(gen, (B, S, H, P), dtype, dev)
    dt = torch.nn.functional.softplus(_randn(gen, (B, S, H), torch.float32, dev) - 3.0)
    A = -torch.linspace(1.0, 16.0, H, device=dev)
    Bm, Cm = (_randn(gen, (B, S, N), dtype, dev) for _ in range(2))
    h0 = _randn(gen, (B, H, P, N), torch.float32, dev) if with_h0 else None
    before = ssd_scan.launches
    y, hf = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, h0=h0)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    yo, ho = ref.ssd_sequential(x, dt, A, Bm, Cm, h0=h0)
    tol = 5e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(y.float(), yo.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(hf, ho, atol=5e-4, rtol=5e-4)


@pytest.mark.parametrize("B,S,W,with_h0", [(3, 1001, 1000, True), (2, 7, 33, False)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
def test_rglru_kernel_vs_plain(dev, B, S, W, with_h0, dtype, tol):
    from repro_torch.kernels import ops, ref, rglru_scan
    gen = torch.Generator().manual_seed(4)
    x = _randn(gen, (B, S, W), dtype, dev)
    a_log = -_randn(gen, (B, S, W), torch.float32, dev).abs() * 0.5
    h0 = _randn(gen, (B, W), torch.float32, dev) if with_h0 else None
    before = rglru_scan.launches
    y, hl = ops.rglru_scan(x, a_log, h0=h0)
    torch.cuda.synchronize()
    assert rglru_scan.launches == before + 1
    yp, hp = ref.rglru_scan(x, a_log, h0=h0)
    torch.testing.assert_close(y.float(), yp.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(hl.float(), hp.float(), atol=tol, rtol=tol)


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


@pytest.mark.parametrize("arch,expected", [
    ("qwen3-1.7b", {"flash_attention": 4 * 2, "decode_attention": 4 * 2 * 3}),
    ("mamba2-1.3b", {"ssd_scan": 4 * 2}),
    ("recurrentgemma-9b", {"rglru_scan": 4 * 2, "flash_attention": 2,
                           "decode_attention": 2 * 3}),
])
def test_smoke_serve_goes_through_the_kernels(dev, arch, expected):
    """Smoke configs: qwen3 4 attention layers; mamba2 4 SSD blocks; the
    hybrid 4 RG-LRU layers and 1 local-attention layer, its 32-token prompt
    over a window of 16."""
    from repro_torch.kernels import decode_attention, flash_attention, ref, rglru_scan, ssd_scan
    from repro_torch.launch import serve
    mods = {"flash_attention": flash_attention, "decode_attention": decode_attention,
            "ssd_scan": ssd_scan, "rglru_scan": rglru_scan}
    for m in mods.values():
        m.launches = 0
    ref.calls = 0
    result = serve.main(["--arch", arch, "--smoke", "--requests", "4",
                         "--batch", "2", "--prompt-len", "32", "--gen-len", "3"])
    assert result["finite"]
    assert {n: m.launches for n, m in mods.items()} == {n: expected.get(n, 0) for n in mods}
    assert ref.calls == 0
