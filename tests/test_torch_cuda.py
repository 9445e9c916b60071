"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where no CUDA device is present (the check
runs inside the fixture, never at import). On a machine with an H100:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances as on the CPU: attention 2e-5 for f32 (TF32 off), 2e-2 for bf16
(its gradient 1e-4 and a relative RMS of 2e-2 against autograd through the
plain forward, 1e-2 against the plain backward, see below); the RG-LRU scan
1e-4 / 3e-2; the SSD scan 5e-4 against the sequential oracle (2e-2 on bf16 y,
which the oracle rounds only at its output); the burst gather exactly.
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
    (2, 130, 130, 4, 2, 80, True, 0, 0),      # Dh 80 on the Dh 128 body, zero columns
    (1, 200, 200, 4, 1, 96, False, 0, 0),     # Dh 96, not causal
    (2, 100, 161, 4, 2, 64, True, 0, 61),     # ragged Sq and Skv under q_offset
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
    if dtype == torch.bfloat16:  # the whole output, as chip_smoke.py holds it
        assert float((got.float() - want.float()).norm() / want.float().norm()) <= 1e-2


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


def _flash_inputs(case, dtype, dev, seed):
    B, Sq, Skv, H, Hkv, Dh = case[:6]
    gen = torch.Generator().manual_seed(seed)
    return (_randn(gen, (B, Sq, H, Dh), dtype, dev),
            *(_randn(gen, (B, Skv, Hkv, Dh), dtype, dev) for _ in range(2)))


def _plain_lse(q, k, *, causal, window, q_offset, scale):
    """(B,H,Sq) logsumexp of the scaled, masked scores in f32, -inf on rows
    with no visible key."""
    from repro_torch.kernels import ref
    B, Sq, H, Dh = q.shape
    Hkv = k.shape[2]
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.reshape(B, Sq, Hkv, H // Hkv, Dh).float(),
                     k.float()) * scale
    mask = ref.attention_mask(Sq, k.shape[1], causal=causal, window=window,
                              q_offset=q_offset, device=q.device)
    return torch.logsumexp(s.masked_fill(~mask, float("-inf")), -1).reshape(B, H, Sq)


@pytest.mark.parametrize("case", [CASES[2], CASES[-1], (1, 256, 256, 2, 1, 256, True, 64, 0)],
                         ids=lambda c: "-".join(map(str, c)))
def test_flash_bf16_calls_are_bitwise_repeatable(dev, case):
    """No atomics and a fixed summation order: two bf16 calls on the same
    inputs give the same bits, output and logsumexp."""
    from repro_torch.kernels import flash_attention
    causal, window, q_offset = case[6:]
    q, k, v = _flash_inputs(case, torch.bfloat16, dev, seed=7)
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              softmax_scale=case[5] ** -0.5, with_lse=True)
    out_a, lse_a = flash_attention._forward(q, k, v, **kw)
    out_b, lse_b = flash_attention._forward(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out_a, out_b)
    assert torch.equal(lse_a, lse_b)


@pytest.mark.parametrize("case", [
    (1, 64, 64, 2, 1, 32, True, 0, -16),     # causal: rows 0-15 see no key
    (1, 200, 200, 4, 2, 64, True, 48, -8),   # window: rows 0-7 see no key
], ids=lambda c: "-".join(map(str, c)))
def test_flash_bf16_lse_vs_logsumexp(dev, case):
    """The bf16 body's logsumexp against torch.logsumexp of the masked,
    scaled f32 scores (bf16 products are exact in f32, so only the summation
    order differs): within 1e-4 (1 + max |lse|) on rows that see a key; +inf
    and an output of 0 on rows that see none."""
    from repro_torch.kernels import flash_attention
    causal, window, q_offset = case[6:]
    scale = case[5] ** -0.5
    mask = dict(causal=causal, window=window, q_offset=q_offset)
    q, k, v = _flash_inputs(case, torch.bfloat16, dev, seed=8)
    out, lse = flash_attention._forward(q, k, v, softmax_scale=scale, with_lse=True, **mask)
    want = _plain_lse(q, k, scale=scale, **mask)
    empty = torch.isinf(want)
    assert int(empty.sum()) > 0 and bool((~empty).any())
    bound = 1e-4 * (1 + float(want[~empty].abs().max()))
    assert float((lse[~empty] - want[~empty]).abs().max()) <= bound
    assert bool((lse[empty] == float("inf")).all())
    assert torch.count_nonzero(out.transpose(1, 2)[empty]) == 0


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    from repro_torch.kernels import decode_attention, flash_attention
    q = torch.zeros(1, 8, 2, 24, device=dev)  # Dh 24 is not a multiple of 16
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention.flash_attention_cuda(q, q[:, :, :1], q[:, :, :1], causal=True,
                                             window=0, q_offset=0, softmax_scale=1.0)
    # contiguous, but 2 bytes past a 16-byte boundary: cp.async cannot move it
    buf = torch.zeros(1 + 8 * 2 * 32, device=dev, dtype=torch.bfloat16)
    q = buf[1:].view(1, 8, 2, 32)
    k = torch.zeros(1, 8, 1, 32, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention.flash_attention_cuda(q, k, k, causal=True, window=0, q_offset=0,
                                             softmax_scale=1.0)
    # the f32 body reads elements, not 16-byte rows: 4 bytes past a boundary runs
    from repro_torch.kernels import ref
    gen = torch.Generator().manual_seed(9)
    buf = _randn(gen, (1 + 8 * 2 * 32,), torch.float32, dev)
    q, k = buf[1:].view(1, 8, 2, 32), _randn(gen, (1, 8, 1, 32), torch.float32, dev)
    torch.testing.assert_close(
        flash_attention.flash_attention_cuda(q, k, k, causal=True, window=0, q_offset=0,
                                             softmax_scale=1.0),
        ref.mha(q, k, k, causal=True, softmax_scale=1.0), atol=2e-5, rtol=2e-5)
    # the backward's bf16 body too; FlashAttention's backward copies a dout off a
    # 16-byte boundary to a fresh tensor first, which gives the same gradients
    from repro_torch.kernels import flash_attention_bwd
    case = (1, 64, 64, 2, 1, 32, True, 0, 0)
    q, k, v, dout, out, lse = _bwd_inputs(case, torch.bfloat16, dev, seed=13)
    buf = torch.empty(1 + dout.numel(), device=dev, dtype=torch.bfloat16)
    dout_off = buf[1:].view(dout.shape)
    dout_off.copy_(dout)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_bwd.flash_attention_bwd_cuda(q, k, v, out, lse, dout_off,
                                                     causal=True, window=0, q_offset=0,
                                                     softmax_scale=32 ** -0.5)

    def grads(d):
        ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o = flash_attention.flash_attention_cuda(*ts, causal=True, window=0, q_offset=0,
                                                 softmax_scale=32 ** -0.5)
        return torch.autograd.grad(o, ts, d)
    for a, b in zip(grads(dout_off), grads(dout)):
        assert torch.equal(a, b)
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


BWD_CASES = [
    # B, Sq, Skv, H, Hkv, Dh, causal, window, q_offset
    (1, 128, 128, 2, 2, 64, True, 0, 0),
    (1, 200, 200, 4, 2, 64, True, 64, 0),
    (2, 96, 160, 16, 1, 32, True, 0, 64),
    (1, 64, 64, 2, 1, 32, True, 0, -16),
    (1, 100, 100, 4, 2, 128, False, 0, 0),
    (1, 384, 384, 2, 1, 16, True, 128, 0),    # Dh 16 (the Dh 32 body), a window over tiles
    (2, 130, 130, 4, 2, 80, True, 0, 0),      # Dh 80 on the Dh 128 body, zero columns
    (1, 200, 200, 4, 1, 96, False, 0, 0),     # Dh 96, not causal
    (2, 100, 161, 4, 2, 64, True, 0, 61),     # ragged Sq and Skv under q_offset
]


@pytest.mark.parametrize("case", BWD_CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_kernel_vs_autograd_through_plain(dev, case, dtype):
    """dq, dk, dv of the kernels' autograd.Function against autograd through
    ref.mha: f32 within 1e-4 (1 + max |ref|), bf16 within a relative RMS of
    2e-2 (the kernels compute in f32 and round dq, dk, dv and the saved
    output to bf16; autograd through the plain version rounds only at its ends)."""
    from repro_torch.kernels import flash_attention, flash_attention_bwd, ops, ref
    B, Sq, Skv, H, Hkv, Dh, causal, window, q_offset = case
    mask = dict(causal=causal, window=window, q_offset=q_offset)
    gen = torch.Generator().manual_seed(5)
    q = _randn(gen, (B, Sq, H, Dh), dtype, dev)
    k, v = (_randn(gen, (B, Skv, Hkv, Dh), dtype, dev) for _ in range(2))
    dout = _randn(gen, (B, Sq, H, Dh), dtype, dev)

    def grads(fn):
        ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
        return torch.autograd.grad(fn(*ts, **mask), ts, dout)
    before = (flash_attention.launches, flash_attention_bwd.launches)
    got = grads(ops.flash_attention)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention_bwd.launches) == (before[0] + 1,
                                                                        before[1] + 1)
    want = grads(ref.mha)
    for a, b in zip(got, want):
        if dtype == torch.float32:
            assert float((a - b).abs().max()) <= 1e-4 * (1 + float(b.abs().max()))
        else:
            assert float((a.float() - b.float()).norm() / b.float().norm()) <= 2e-2
    if q_offset < 0:  # rows that see no key get no gradient
        assert torch.count_nonzero(got[0][:, :-q_offset]) == 0


def _bwd_inputs(case, dtype, dev, seed):
    """q, k, v, dout, and the forward kernel's output and logsumexp."""
    from repro_torch.kernels import flash_attention
    causal, window, q_offset = case[6:]
    q, k, v = _flash_inputs(case, dtype, dev, seed)
    dout = _randn(torch.Generator().manual_seed(seed + 1), q.shape, dtype, dev)
    out, lse = flash_attention._forward(q, k, v, causal=causal, window=window,
                                        q_offset=q_offset, softmax_scale=case[5] ** -0.5,
                                        with_lse=True)
    return q, k, v, dout, out, lse


@pytest.mark.parametrize("case", BWD_CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_vs_plain_bwd(dev, case, dtype):
    """The backward kernel against ref.mha_bwd given the same out and lse (the
    forward kernel's): f32 within 1e-4 (1 + max |ref|); bf16 each of dq, dk,
    dv within a relative RMS of 1e-2 (the kernel rounds P and dS to bf16 as
    operands of its products, and its outputs; ref.mha_bwd rounds only its
    outputs)."""
    from repro_torch.kernels import flash_attention_bwd, ref
    causal, window, q_offset = case[6:]
    mask = dict(causal=causal, window=window, q_offset=q_offset,
                softmax_scale=case[5] ** -0.5)
    q, k, v, dout, out, lse = _bwd_inputs(case, dtype, dev, seed=11)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd.flash_attention_bwd_cuda(q, k, v, out, lse, dout, **mask)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 1
    want = ref.mha_bwd(q, k, v, out, lse, dout, **mask)
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape and bool(torch.isfinite(a).all())
        if dtype == torch.float32:
            assert float((a - b).abs().max()) <= 1e-4 * (1 + float(b.abs().max()))
        else:
            assert float((a.float() - b.float()).norm() / b.float().norm()) <= 1e-2


@pytest.mark.parametrize("case", [BWD_CASES[1], BWD_CASES[2], BWD_CASES[-1]],
                         ids=lambda c: "-".join(map(str, c)))
def test_flash_bwd_bf16_calls_are_bitwise_repeatable(dev, case):
    """No atomics and a fixed summation order: two bf16 backward calls on the
    same inputs give the same bits."""
    from repro_torch.kernels import flash_attention_bwd
    causal, window, q_offset = case[6:]
    q, k, v, dout, out, lse = _bwd_inputs(case, torch.bfloat16, dev, seed=12)
    kw = dict(causal=causal, window=window, q_offset=q_offset, softmax_scale=case[5] ** -0.5)
    a = flash_attention_bwd.flash_attention_bwd_cuda(q, k, v, out, lse, dout, **kw)
    b = flash_attention_bwd.flash_attention_bwd_cuda(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_flash_backward_refuses_head_dims_past_128(dev):
    from repro_torch.kernels import ops
    q = torch.zeros(1, 16, 2, 256, device=dev, requires_grad=True)
    k = torch.zeros(1, 16, 1, 256, device=dev, requires_grad=True)
    out = ops.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="ROADMAP.md"):
        out.sum().backward()


def test_wrappers_without_a_backward_raise_under_autograd(dev):
    """decode, SSD and RG-LRU have no backward kernel: under grad mode an
    input that requires grad must raise, not yield an output without grad."""
    from repro_torch.kernels import ops
    q = torch.zeros(1, 2, 16, device=dev, requires_grad=True)
    kc = torch.zeros(1, 8, 1, 16, device=dev)
    cl = torch.ones(1, dtype=torch.int32, device=dev)
    x = torch.zeros(1, 8, 2, 8, device=dev, requires_grad=True)
    dt, A = torch.ones(1, 8, 2, device=dev), -torch.ones(2, device=dev)
    Bm = torch.zeros(1, 8, 4, device=dev)
    xr = torch.zeros(1, 8, 16, device=dev, requires_grad=True)
    calls = [lambda: ops.decode_attention(q, kc, kc, cl),
             lambda: ops.ssd_scan(x, dt, A, Bm, Bm, chunk=8),
             lambda: ops.rglru_scan(xr, torch.zeros(1, 8, 16, device=dev))]
    for call in calls:
        with pytest.raises(RuntimeError, match="ROADMAP.md"):
            call()
        with torch.no_grad():
            call()


GATHER_CASES = [
    # n_slots, slot_size, slots, lengths, out_width
    (64, 256, list(range(0, 64, 4)), [1, 255, 17, 256] * 4, 256),
    (64, 128, [63, 0, 5, 9, 11, 2, 3, 40], [127, 1, 64, 0, 128, 5, 90, 100], 300),
    (64, 64, list(range(32)), [i * 2 for i in range(32)], 32),
    (4, 16, [5, -1, -5, -10, 3], [16, 100, -3, 16, 8], 16),
    (4, 16, [], [], 16),
    (4096, 1518, list(range(0, 4096, 16)), [64 + 5 * i for i in range(256)], 1518),
]


@pytest.mark.parametrize("case", GATHER_CASES, ids=lambda c: f"{c[0]}x{c[1]}-n{len(c[2])}")
def test_burst_gather_kernel_vs_plain(dev, case):
    from repro_torch.kernels import burst_gather, ops, ref
    n_slots, slot_size, slots, lengths, width = case
    gen = torch.Generator().manual_seed(6)
    arena = torch.randint(0, 256, (n_slots, slot_size), generator=gen,
                          dtype=torch.uint8).to(dev)
    s = torch.tensor(slots, dtype=torch.int32, device=dev)
    n = torch.tensor(lengths, dtype=torch.int32, device=dev)
    before = burst_gather.launches
    got = ops.burst_gather(arena, s, n, width)
    torch.cuda.synchronize()
    assert burst_gather.launches == before + (1 if slots else 0)
    assert got.shape == (len(slots), width) and got.device == arena.device
    assert torch.equal(got, ref.burst_gather(arena, s, n, width))


def test_loss_backward_through_the_kernels_reaches_attention_weights(dev, monkeypatch):
    """The smoke model in f32: every gradient with the kernels equals the
    plain path's within 1e-4 of its largest magnitude, and wq, wk, wv get
    non-zero gradients through attention."""
    from repro_torch import tree
    from repro_torch.data.pipeline import DataConfig, synth_tokens
    from repro_torch.kernels import flash_attention_bwd, ops, ref
    from repro_torch.launch import serve
    from repro_torch.models.registry import get_smoke_config
    from repro_torch.runtime.steps import loss_and_grads
    cfg = get_smoke_config("qwen3-1.7b").replace(param_dtype="float32",
                                                 compute_dtype="float32")
    params = serve.init_params(cfg, 0, dev)
    host = synth_tokens(cfg, DataConfig(seq_len=64, global_batch=2, seed=2), 0, 1, 0)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    before = flash_attention_bwd.launches
    loss, _, got = loss_and_grads(cfg, params, batch)
    assert flash_attention_bwd.launches == before + cfg.n_layers
    monkeypatch.setattr(ops, "flash_attention", lambda q, k, v, **kw: ref.mha(q, k, v, **kw))
    loss_p, _, want = loss_and_grads(cfg, params, batch)
    assert abs(float(loss) - float(loss_p)) <= 1e-5 * abs(float(loss_p))
    got, want = tree.leaf_paths(got), tree.leaf_paths(want)
    for key in want:
        bound = 1e-4 * float(want[key].abs().max())
        assert float((got[key] - want[key]).abs().max()) <= bound, key
        if key.split("/")[-1] in ("wq", "wk", "wv"):
            assert float(got[key].abs().max()) > 0, key


def test_bypass_dataplane_on_cuda(dev):
    """Pinned buffers, side-stream copies and event polling deliver the
    kernel feed's batches on the card, and the ring drains cleanly."""
    from repro_torch.core.dataplane import BypassDataplane, KernelStackFeed
    from repro_torch.data.pipeline import DataConfig, stream_factory
    from repro_torch.models.registry import get_smoke_config
    cfg = get_smoke_config("qwen3-1.7b")
    factory = stream_factory(cfg, DataConfig(seq_len=64, global_batch=8, seed=3), n_steps=12)
    kf = KernelStackFeed(factory(0, 1), dev)
    bp = BypassDataplane(factory, device=dev, depth=3, ports=1)
    try:
        for _ in range(12):
            a, b = kf.next_batch(), bp.next_batch(timeout_s=30.0)
            for key in a:
                assert b[key].device == dev and b[key].dtype == torch.int32
                # use on the current stream right away: the hand-over orders it
                assert torch.equal(a[key], b[key].clone())
        assert bp.next_batch(timeout_s=30.0) is None
        assert bp.stats.batches == 12 and bp.stats.avg_occupancy >= 1
    finally:
        bp.stop()
    bp = BypassDataplane(factory, device=dev, depth=3, ports=2)
    try:
        assert bp.next_batch(timeout_s=30.0) is not None
        bp.drop_inflight()
        assert sorted(bp._free_slots) == [0, 1, 2]
    finally:
        bp.stop()


def test_smoke_train_goes_through_the_kernels(dev):
    """Two smoke train steps (4 layers): per step each layer's forward and
    its recompute, and one backward; no plain call."""
    from repro_torch.kernels import flash_attention, flash_attention_bwd, ref
    from repro_torch.launch import train
    flash_attention.launches = flash_attention_bwd.launches = ref.calls = 0
    rt = train.main(["--arch", "qwen3-1.7b", "--smoke", "--steps", "2", "--seq-len", "32",
                     "--global-batch", "2", "--log-every", "1"])
    assert (flash_attention.launches, flash_attention_bwd.launches) == (16, 8)
    assert ref.calls == 0
    assert all(m["loss"] == m["loss"] for m in rt.metrics_log)  # finite, not NaN
