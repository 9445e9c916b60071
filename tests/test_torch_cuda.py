"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where no CUDA device is present (the check
runs inside the fixture, never at import). On a machine with an H100:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances as on the CPU: attention 2e-5 for f32 (TF32 off), 2e-2 for bf16
(its gradient 1e-4 and a relative RMS of 2e-2 against autograd through the
plain forward, 1e-2 against the plain backward, see below); the RG-LRU scan
1e-4 / 3e-2 (its kernels reassociate only the state entering each chunk, about
L ulp), its gradient as attention's; the SSD scan 5e-4 against the sequential oracle (2e-2 on bf16 y,
which the oracle rounds only at its output) and, at the prefill shape in bf16,
a relative RMS of 1e-2 against the chunked plain version; the burst gather
exactly.
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
    (2, 300, 300, 4, 4, 80, False, 0, 0),     # bidirectional MHA at Dh 80 (hubert-xlarge)
    (2, 300, 300, 12, 2, 128, True, 0, 0),    # GQA group 6 (internvl2-26b)
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
    _flash_vs_plain(dev, case, dtype, tol)


def _flash_vs_plain(dev, case, dtype, tol):
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


@pytest.mark.parametrize("case", [
    (2, 300, 300, 6, 2, 128, True, 0, 0),        # group 3 (phi4-mini, llama3.2), ragged tiles
    (2, 300, 300, 10, 2, 128, True, 0, 0),       # group 5 (llama4-maverick)
    (1, 4608, 4608, 8, 2, 128, True, 4096, 0),   # mixtral-8x7b: window 4096 at Dh 128, S > window
    (1, 600, 600, 6, 2, 128, True, 256, 0),      # group 3 under a window that cuts tiles
], ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
def test_flash_kernel_at_the_transformer_family_shapes_vs_plain(dev, case, dtype, tol):
    """The GQA groups and the window that the transformer archs served since
    the MoE local path bring to the flash kernel, against ref.mha."""
    _flash_vs_plain(dev, case, dtype, tol)


def _decode_close(got, want, dtype, tol):
    """f32 within 2e-5; bf16 within 2e-2 elementwise and, as chip_smoke.py
    holds it, the whole output within a relative RMS of 1e-2."""
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    if dtype == torch.bfloat16:
        assert float((got.float() - want.float()).norm() / want.float().norm()) <= 1e-2


@pytest.mark.parametrize("group", [1, 2, 3, 4, 5, 8, 12, 16])
@pytest.mark.parametrize("Dh", [20, 24, 64, 128, 256])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
def test_decode_kernel_vs_plain(dev, group, Dh, dtype, tol):
    """GQA groups the wrapper takes (3 and 5 are phi4-mini and llama3.2's,
    and llama4-maverick's: not divisors of the mma tile's 16 rows), at head
    dims that run the bf16 mma body (64, 128, 256; 24 with its last k-step
    half zero) and the FMA body (20: rows not a multiple of 16 bytes; every
    f32 shape), over a ragged cache with an empty row, a one-key row and a
    full one."""
    from repro_torch.kernels import decode_attention, ops, ref
    B, C, Hkv = 4, 300, 2
    gen = torch.Generator().manual_seed(1)
    q = _randn(gen, (B, group * Hkv, Dh), dtype, dev)
    kc, vc = (_randn(gen, (B, C, Hkv, Dh), dtype, dev) for _ in range(2))
    cl = torch.tensor([0, 1, 300, 157], dtype=torch.int32, device=dev)
    before = decode_attention.launches
    got = ops.decode_attention(q, kc, vc, cl)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    assert torch.count_nonzero(got[0]) == 0
    _decode_close(got, ref.decode_attention(q, kc, vc, cl), dtype, tol)


@pytest.mark.parametrize("B,C,H,Dh,lens", [(4, 2048, 16, 256, (2048, 2048, 1000, 0)),
                                             (2, 300, 12, 64, (300, 5))])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
def test_decode_kernel_large_group_vs_plain(dev, B, C, H, Dh, lens, dtype, tol):
    """Group 16 at head_dim 256 over a full 2048-slot ring (recurrentgemma-9b's
    decode shape, 32 splits of 64 keys) and group 12 (12 of the mma tile's
    16 rows)."""
    from repro_torch.kernels import decode_attention, ops, ref
    gen = torch.Generator().manual_seed(2)
    q = _randn(gen, (B, H, Dh), dtype, dev)
    kc, vc = (_randn(gen, (B, C, 1, Dh), dtype, dev) for _ in range(2))
    cl = torch.tensor(lens, dtype=torch.int32, device=dev)
    before = decode_attention.launches
    got = ops.decode_attention(q, kc, vc, cl)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    empty = [i for i, n in enumerate(lens) if n == 0]
    assert torch.count_nonzero(got[empty]) == 0
    _decode_close(got, ref.decode_attention(q, kc, vc, cl), dtype, tol)


@pytest.mark.parametrize("B,C,H,Hkv,Dh,lens", [(4, 2048, 16, 1, 256, (2048, 2048, 1000, 0)),
                                                 (4, 544, 16, 8, 128, (1, 200, 544, 377))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_calls_are_bitwise_repeatable(dev, B, C, H, Hkv, Dh, lens, dtype):
    """No atomics and a fixed order of sums in the partial pass and the
    combine: two calls on the same inputs give the same bits (at both serve
    shapes)."""
    from repro_torch.kernels import decode_attention
    gen = torch.Generator().manual_seed(5)
    q = _randn(gen, (B, H, Dh), dtype, dev)
    kc, vc = (_randn(gen, (B, C, Hkv, Dh), dtype, dev) for _ in range(2))
    cl = torch.tensor(lens, dtype=torch.int32, device=dev)
    a = decode_attention.decode_attention_cuda(q, kc, vc, cl, softmax_scale=Dh ** -0.5)
    b = decode_attention.decode_attention_cuda(q, kc, vc, cl, softmax_scale=Dh ** -0.5)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("group", [1, 3, 4, 16])
@pytest.mark.parametrize("Dh", [20, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_logsumexp_vs_plain(dev, group, Dh, dtype):
    """The combine's logsumexp (return_lse) against the plain float64 one:
    within 1e-4 (1 + |lse|), -inf on a row of length 0; one launch a call,
    and the output bitwise the call's without it, on both bodies."""
    from repro_torch.kernels import decode_attention, ops, ref
    B, C, Hkv = 4, 300, 2
    gen = torch.Generator().manual_seed(7)
    q = _randn(gen, (B, group * Hkv, Dh), dtype, dev)
    kc, vc = (_randn(gen, (B, C, Hkv, Dh), dtype, dev) for _ in range(2))
    cl = torch.tensor([0, 1, 300, 157], dtype=torch.int32, device=dev)
    plain = ops.decode_attention(q, kc, vc, cl)
    before = decode_attention.launches
    got, lse = ops.decode_attention(q, kc, vc, cl, return_lse=True)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    assert torch.equal(got, plain)
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (B, group * Hkv)
    _, want = ref.decode_attention(q, kc, vc, cl, return_lse=True)
    assert bool(torch.isneginf(lse[0]).all())
    torch.testing.assert_close(lse[1:], want[1:], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("B,C,H,Hkv,Dh,lens", [(4, 2048, 16, 1, 256, (2048, 2048, 1000, 0)),
                                                 (4, 544, 16, 8, 128, (1, 200, 544, 377)),
                                                 (4, 544, 24, 8, 128, (1, 200, 544, 377))])
@pytest.mark.parametrize("m", [2, 4, 16])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
def test_decode_slot_shares_merge_to_the_whole_call(dev, B, C, H, Hkv, Dh, lens, m, dtype,
                                                    tol):
    """Context-sharded decode's arithmetic: the cache cut into m slot shares
    (recurrentgemma-9b's, qwen3-1.7b's and phi4-mini-3.8b's decode shapes),
    the kernel on each share with its own valid count and the logsumexp,
    the partials merged in order (``axes.merge_partials``), against the
    kernel's whole call at decode's bounds; rows of length 0 exactly 0."""
    from repro_torch.kernels import ops
    from repro_torch.parallel.axes import merge_partials
    gen = torch.Generator().manual_seed(8)
    q = _randn(gen, (B, H, Dh), dtype, dev)
    kc, vc = (_randn(gen, (B, C, Hkv, Dh), dtype, dev) for _ in range(2))
    cl = torch.tensor(lens, dtype=torch.int32, device=dev)
    n = C // m
    parts = [ops.decode_attention(q, kc[:, r * n:(r + 1) * n].contiguous(),
                                  vc[:, r * n:(r + 1) * n].contiguous(),
                                  torch.clamp(cl - r * n, 0, n).to(torch.int32),
                                  return_lse=True) for r in range(m)]
    got = merge_partials(torch.stack([o for o, _ in parts]),
                         torch.stack([s for _, s in parts])).to(dtype)
    torch.cuda.synchronize()
    empty = [i for i, k in enumerate(lens) if k == 0]
    assert torch.count_nonzero(got[empty]) == 0
    _decode_close(got, ops.decode_attention(q, kc, vc, cl), dtype, tol)


def test_decode_refuses_bf16_off_a_16_byte_boundary(dev):
    """The mma body moves 16-byte rows with cp.async: a bf16 cache view 2
    bytes past a boundary raises, and is not copied behind the caller's
    back (the C entry point refuses it too, past the wrapper's check); the
    FMA body (bf16 rows of 20 elements) reads elements and runs."""
    from repro_torch.kernels import decode_attention, ref
    gen = torch.Generator().manual_seed(6)
    cl = torch.tensor([8], dtype=torch.int32, device=dev)
    for Dh, raises in ((32, True), (20, False)):
        q = _randn(gen, (1, 2, Dh), torch.bfloat16, dev)
        buf = _randn(gen, (1 + 8 * Dh,), torch.bfloat16, dev)
        kc = buf[1:].view(1, 8, 1, Dh)
        before = decode_attention.launches
        if raises:
            with pytest.raises(ValueError, match="16-byte"):
                decode_attention.decode_attention_cuda(q, kc, kc, cl, softmax_scale=1.0)
            assert decode_attention.launches == before
            plan = decode_attention.plan_splits(1, 8, 1, 2, Dh, torch.bfloat16, 132)
            with pytest.raises(RuntimeError, match="misaligned"):
                decode_attention._launch(q, kc, kc, cl, 1.0, plan)
        else:
            got = decode_attention.decode_attention_cuda(q, kc, kc, cl, softmax_scale=1.0)
            _decode_close(got, ref.decode_attention(q, kc, kc, cl, softmax_scale=1.0),
                          torch.bfloat16, 2e-2)


def _ssd_inputs(dev, B, S, H, P, N, with_h0, dtype, seed=3):
    gen = torch.Generator().manual_seed(seed)
    x = _randn(gen, (B, S, H, P), dtype, dev)
    dt = torch.nn.functional.softplus(_randn(gen, (B, S, H), torch.float32, dev) - 3.0)
    A = -torch.linspace(1.0, 16.0, H, device=dev)
    Bm, Cm = (_randn(gen, (B, S, N), dtype, dev) for _ in range(2))
    h0 = _randn(gen, (B, H, P, N), torch.float32, dev) if with_h0 else None
    return x, dt, A, Bm, Cm, h0


@pytest.mark.parametrize("B,S,H,P,N,chunk,with_h0", [
    (2, 300, 8, 64, 128, 256, True),
    (2, 37, 3, 8, 16, 8, True),
    (1, 512, 4, 64, 128, 256, False),
    (1, 1024, 4, 64, 128, 128, True),   # the state pass carries h0 across 8 chunks
    (2, 333, 4, 32, 64, 64, True),      # ragged S over 6 chunks at P 32, N 64
    (2, 40, 3, 16, 32, 1, True),        # chunk 1: every step its own chunk
    (1, 100, 3, 64, 128, 256, True),    # S shorter than the chunk
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_vs_oracle(dev, B, S, H, P, N, chunk, with_h0, dtype):
    from repro_torch.kernels import ops, ref, ssd_scan
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(dev, B, S, H, P, N, with_h0, dtype)
    before = ssd_scan.launches
    y, hf = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, h0=h0)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    yo, ho = ref.ssd_sequential(x, dt, A, Bm, Cm, h0=h0)
    tol = 5e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(y.float(), yo.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(hf, ho, atol=5e-4, rtol=5e-4)


def test_ssd_kernel_at_the_prefill_shape_vs_plain(dev):
    """mamba2-1.3b's prefill in bf16 against the chunked plain version, which
    rounds its dot inputs to bf16 where the kernel stays in f32: within the
    relative RMS of chip_smoke.py (1e-2)."""
    from repro_torch.kernels import ref, ssd_scan
    x, dt, A, Bm, Cm, _ = _ssd_inputs(dev, 4, 2048, 64, 64, 128, False, torch.bfloat16)
    y, hf = ssd_scan.ssd_scan_cuda(x, dt, A, Bm, Cm, chunk=256)
    yp, hp = ref.ssd_scan(x, dt, A, Bm, Cm, chunk=256)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(hf).all())
    for got, want in ((y, yp), (hf, hp)):
        assert float((got.float() - want.float()).norm() / want.float().norm()) <= 1e-2


@pytest.mark.parametrize("case", [(4, 2048, 64, 64, 128, 256, False),
                                  (2, 333, 4, 32, 64, 64, True)],
                         ids=lambda c: "-".join(map(str, c)))
def test_ssd_kernel_repeats_bitwise(dev, case):
    from repro_torch.kernels import ssd_scan
    B, S, H, P, N, chunk, with_h0 = case
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(dev, B, S, H, P, N, with_h0, torch.bfloat16)
    y1, h1 = ssd_scan.ssd_scan_cuda(x, dt, A, Bm, Cm, chunk=chunk, h0=h0)
    y2, h2 = ssd_scan.ssd_scan_cuda(x, dt, A, Bm, Cm, chunk=chunk, h0=h0)
    assert torch.equal(y1, y2) and torch.equal(h1, h2)


def test_ssd_kernel_on_a_side_stream(dev):
    """The kernels and their workspace follow the caller's current stream."""
    from repro_torch.kernels import ssd_scan
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(dev, 2, 700, 8, 64, 128, True, torch.bfloat16)
    want = ssd_scan.ssd_scan_cuda(x, dt, A, Bm, Cm, chunk=256, h0=h0)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        got = ssd_scan.ssd_scan_cuda(x, dt, A, Bm, Cm, chunk=256, h0=h0)
    torch.cuda.current_stream(dev).wait_stream(side)
    torch.cuda.synchronize(dev)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


SSD_BWD_CASES = [
    # B, S, H, P, N, chunk, h0, a cotangent on the final state
    (2, 300, 8, 64, 128, 256, True, True),    # ragged S: one full and one partial chunk
    (2, 37, 3, 8, 16, 8, True, False),        # smoke-sized heads, ragged S
    (2, 40, 3, 16, 32, 1, True, True),        # chunk 1
    (1, 1024, 4, 64, 128, 128, False, True),  # 8 chunks of two tiles, no h0
    (2, 333, 4, 32, 64, 64, True, True),      # ragged S over 6 chunks at P 32, N 64
]


def _ssd_grads(fn, x, dt, A, Bm, Cm, h0, dy, dh):
    """The gradients of <y, dy> + <h_final, dh> through ``fn`` by autograd."""
    leaves = [t.detach().clone().requires_grad_(True) for t in (x, dt, A, Bm, Cm)]
    h0l = h0.detach().clone().requires_grad_(True) if h0 is not None else None
    y, hf = fn(*leaves, h0l)
    loss = (y.float() * dy.float()).sum() + ((hf * dh).sum() if dh is not None else 0)
    return torch.autograd.grad(loss, leaves + ([h0l] if h0l is not None else []))


@pytest.mark.parametrize("case", SSD_BWD_CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_backward_vs_autograd_through_the_plain_version(dev, case, dtype):
    """SSDScan's gradients against autograd through ref.ssd_scan: f32 max abs
    within 1e-4 (1 + max |ref|); bf16 a relative RMS of 2e-2 (the plain
    version rounds its dot inputs to bf16, the kernels do all math in f32)."""
    from repro_torch.kernels import ops, ref, ssd_scan_bwd
    B, S, H, P, N, chunk, with_h0, with_dh = case
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(dev, B, S, H, P, N, with_h0, dtype)
    gen = torch.Generator().manual_seed(9)
    dy = _randn(gen, x.shape, dtype, dev)
    dh = _randn(gen, (B, H, P, N), torch.float32, dev) if with_dh else None
    before = ssd_scan_bwd.launches
    got = _ssd_grads(lambda *a: ops.ssd_scan(*a[:5], chunk=chunk, h0=a[5]),
                     x, dt, A, Bm, Cm, h0, dy, dh)
    assert ssd_scan_bwd.launches == before + 1
    want = _ssd_grads(lambda *a: ref.ssd_scan(*a[:5], chunk=chunk, h0=a[5]),
                      x, dt, A, Bm, Cm, h0, dy, dh)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all()) and g.dtype == w.dtype
        if dtype == torch.float32:
            bound = 1e-4 * (1 + float(w.abs().max()))
            assert float((g - w).abs().max()) <= bound
        else:
            assert float((g.float() - w.float()).norm() / w.float().norm()) <= 2e-2


@pytest.mark.parametrize("case", SSD_BWD_CASES + [(4, 2048, 64, 64, 128, 256, False, False)],
                         ids=lambda c: "-".join(map(str, c)))
def test_ssd_backward_kernel_vs_the_plain_backward(dev, case):
    """The kernels alone against ref.ssd_scan_bwd on the same bf16 inputs:
    each gradient within a relative RMS of 1e-2; two calls bitwise equal."""
    from repro_torch.kernels import ref, ssd_scan, ssd_scan_bwd
    B, S, H, P, N, chunk, with_h0, with_dh = case
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(dev, B, S, H, P, N, with_h0, torch.bfloat16)
    gen = torch.Generator().manual_seed(10)
    dy = _randn(gen, x.shape, torch.bfloat16, dev)
    dh = _randn(gen, (B, H, P, N), torch.float32, dev) if with_dh else None
    _, _, ws = ssd_scan._forward(x, dt, A, Bm, Cm, chunk=chunk, h0=h0)
    got = ssd_scan_bwd.ssd_scan_bwd_cuda(x, dt, A, Bm, Cm, h0, dy, dh, chunk=chunk,
                                         fwd_workspace=ws)
    again = ssd_scan_bwd.ssd_scan_bwd_cuda(x, dt, A, Bm, Cm, h0, dy, dh, chunk=chunk,
                                           fwd_workspace=ws)
    want = ref.ssd_scan_bwd(x, dt, A, Bm, Cm, h0, dy, dh, chunk=chunk)
    torch.cuda.synchronize()
    assert (got[5] is None) == (h0 is None)
    for g, a, w in zip(got, again, want):
        if w is None:
            continue
        assert torch.equal(g, a)
        assert float((g.float() - w.float()).norm() / w.float().norm()) <= 1e-2


@pytest.mark.parametrize("dy_scale", [1e3, 1e-3], ids=lambda v: f"dy{v:g}")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_backward_at_adversarial_magnitudes(dev, dtype, dy_scale):
    """A 4x as negative (-4 to -64), so exp(cum) spans hundreds of decades
    within a chunk and most of L underflows to 0, with dy scaled by 1e3 and
    1e-3: the operands split into bf16 parts keep every bound of the checks
    above, and two calls stay bitwise equal."""
    from repro_torch.kernels import ops, ref, ssd_scan, ssd_scan_bwd
    B, S, H, P, N, chunk = 2, 300, 8, 64, 128, 256
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(dev, B, S, H, P, N, True, dtype)
    A = A * 4.0
    gen = torch.Generator().manual_seed(11)
    dy = (_randn(gen, x.shape, torch.float32, dev) * dy_scale).to(dtype)
    dh = _randn(gen, (B, H, P, N), torch.float32, dev)
    got = _ssd_grads(lambda *a: ops.ssd_scan(*a[:5], chunk=chunk, h0=a[5]),
                     x, dt, A, Bm, Cm, h0, dy, dh)
    want = _ssd_grads(lambda *a: ref.ssd_scan(*a[:5], chunk=chunk, h0=a[5]),
                      x, dt, A, Bm, Cm, h0, dy, dh)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all()) and g.dtype == w.dtype
        if dtype == torch.float32:
            assert float((g - w).abs().max()) <= 1e-4 * (1 + float(w.abs().max()))
        else:
            assert float((g.float() - w.float()).norm() / w.float().norm()) <= 2e-2
    _, _, ws = ssd_scan._forward(x, dt, A, Bm, Cm, chunk=chunk, h0=h0)
    k1 = ssd_scan_bwd.ssd_scan_bwd_cuda(x, dt, A, Bm, Cm, h0, dy, dh, chunk=chunk,
                                       fwd_workspace=ws)
    k2 = ssd_scan_bwd.ssd_scan_bwd_cuda(x, dt, A, Bm, Cm, h0, dy, dh, chunk=chunk,
                                       fwd_workspace=ws)
    plain = ref.ssd_scan_bwd(x, dt, A, Bm, Cm, h0, dy, dh, chunk=chunk)
    for a, b, w in zip(k1, k2, plain):
        assert torch.equal(a, b)
        if dtype == torch.float32:
            assert float((a - w).abs().max()) <= 1e-4 * (1 + float(w.abs().max()))
        else:
            assert float((a.float() - w.float()).norm() / w.float().norm()) <= 1e-2


def test_ssd_backward_plan_shared_memory_is_the_kernels(dev):
    """ssd_scan_bwd.plan's dynamic shared memory per kernel is what the
    library launches with, for both dtypes."""
    import ctypes
    from repro_torch.kernels import _build, ssd_scan_bwd
    lib, _ = ssd_scan_bwd._fn()
    fn = lib.ssd_scan_bwd_smem
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)], ctypes.c_int
    for dtype in (torch.float32, torch.bfloat16):
        got = (ctypes.c_int * 5)()
        assert fn(_build.DTYPE_CODES[dtype], got) == 0
        p = ssd_scan_bwd.plan(4, 2048, 64, 64, 128, 256, dtype)
        assert tuple(got) == (p.dstate_smem, p.scores_smem, p.dbc_part_smem, p.dbc_sum_smem,
                              p.dx_smem)


def _rglru_inputs(dev, B, S, W, with_h0, dtype, seed=4, unit_decay=False):
    gen = torch.Generator().manual_seed(seed)
    x = _randn(gen, (B, S, W), dtype, dev)
    a_log = -_randn(gen, (B, S, W), torch.float32, dev).abs() * 0.5
    if unit_decay:  # a = 1 in f32: the gate is 1e-6 and h0 carries through
        a_log = torch.where(a_log < -0.3, 0.0, -1e-9)
    h0 = _randn(gen, (B, W), torch.float32, dev) if with_h0 else None
    return x, a_log, h0


# The plan's chunk L is 64: S 63, 64, 65 and 197 are L - 1 (one chunk), L,
# L + 1 (a last chunk of one step) and 3L + 5; the prefill shape runs 48 chunks.
RGLRU_CHUNK_CASES = [(2, 63, 33), (2, 64, 33), (2, 65, 33), (2, 197, 33)]


@pytest.mark.parametrize("B,S,W,with_h0", [(3, 1001, 1000, True), (2, 7, 33, False)]
                         + [(*shape, True) for shape in RGLRU_CHUNK_CASES]
                         + [(4, 3072, 4096, True)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
def test_rglru_kernel_vs_plain(dev, B, S, W, with_h0, dtype, tol):
    from repro_torch.kernels import ops, ref, rglru_scan
    x, a_log, h0 = _rglru_inputs(dev, B, S, W, with_h0, dtype)
    before = rglru_scan.launches
    y, hl = ops.rglru_scan(x, a_log, h0=h0)
    torch.cuda.synchronize()
    assert rglru_scan.launches == before + 1
    yp, hp = ref.rglru_scan(x, a_log, h0=h0)
    torch.testing.assert_close(y.float(), yp.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(hl.float(), hp.float(), atol=tol, rtol=tol)
    assert torch.equal(hl, y[:, -1])  # the last chunk's own state, as a sequential scan


@pytest.mark.parametrize("B,S,W", [(2, 197, 33), (3, 1001, 1000)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
def test_rglru_kernel_with_unit_decay(dev, B, S, W, dtype, tol):
    """a_log 0: decay products of 1 and a gate of 1e-6 in every chunk."""
    from repro_torch.kernels import ref, rglru_scan
    x, a_log, h0 = _rglru_inputs(dev, B, S, W, True, dtype, seed=8, unit_decay=True)
    y, hl = rglru_scan.rglru_scan_cuda(x, a_log, h0=h0)
    yp, hp = ref.rglru_scan(x, a_log, h0=h0)
    torch.testing.assert_close(y.float(), yp.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(hl.float(), hp.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("case", [(4, 3072, 4096, False), (3, 1001, 1000, True)],
                         ids=lambda c: "-".join(map(str, c)))
def test_rglru_kernel_repeats_bitwise(dev, case):
    from repro_torch.kernels import rglru_scan
    x, a_log, h0 = _rglru_inputs(dev, *case, torch.bfloat16, seed=5)
    before = rglru_scan.launches
    y1, h1 = rglru_scan.rglru_scan_cuda(x, a_log, h0=h0)
    y2, h2 = rglru_scan.rglru_scan_cuda(x, a_log, h0=h0)
    assert rglru_scan.launches == before + 2
    assert torch.equal(y1, y2) and torch.equal(h1, h2)


def test_rglru_kernel_on_a_side_stream(dev):
    """The kernels and their workspace follow the caller's current stream."""
    from repro_torch.kernels import rglru_scan
    x, a_log, h0 = _rglru_inputs(dev, 3, 1001, 1000, True, torch.float32, seed=6)
    want = rglru_scan.rglru_scan_cuda(x, a_log, h0=h0)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        got = rglru_scan.rglru_scan_cuda(x, a_log, h0=h0)
    torch.cuda.current_stream(dev).wait_stream(side)
    torch.cuda.synchronize(dev)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


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
    ("granite-8b", {"flash_attention": 4 * 2, "decode_attention": 4 * 2 * 3}),
    ("mixtral-8x7b", {"flash_attention": 4 * 2, "decode_attention": 4 * 2 * 3}),
    ("llama4-maverick-400b-a17b", {"flash_attention": 4 * 2, "decode_attention": 4 * 2 * 3}),
    ("mamba2-1.3b", {"ssd_scan": 4 * 2}),
    ("recurrentgemma-9b", {"rglru_scan": 4 * 2, "flash_attention": 2,
                           "decode_attention": 2 * 3}),
    ("internvl2-26b", {"flash_attention": 4 * 2, "decode_attention": 4 * 2 * 3}),
])
def test_smoke_serve_goes_through_the_kernels(dev, arch, expected):
    """Smoke configs: qwen3, granite, mixtral (window 32), llama4 and
    internvl2 (16 patches before the prompt) 4 attention layers each
    (head_dim 16; the phi4 and llama3.2 smoke configs have head_dim 10,
    which the kernels do not take); mamba2 4 SSD blocks; the hybrid 4 RG-LRU
    layers and 1 local-attention layer, its 32-token prompt over a window of
    16."""
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


def test_internvl2_serve_at_full_width_goes_through_the_kernels(dev):
    """internvl2-26b at full width (48 heads on 8, head_dim 128), cut to 2 of
    its 48 layers: launch.serve with its 256 patches before a 64-token
    prompt, every launch counted and no plain version run."""
    from repro_torch.kernels import decode_attention, flash_attention, ref, rglru_scan, ssd_scan
    from repro_torch.launch import serve
    from repro_torch.models.registry import get_config
    cfg = get_config("internvl2-26b").replace(n_layers=2)
    params = serve.init_params(cfg, 0, dev)
    mods = {"flash_attention": flash_attention, "decode_attention": decode_attention,
            "ssd_scan": ssd_scan, "rglru_scan": rglru_scan}
    for m in mods.values():
        m.launches = 0
    ref.calls = 0
    result = serve.serve(cfg, params, requests=4, batch=2, prompt_len=64, gen_len=3, seed=0,
                         device=dev)
    assert result["finite"] and tuple(result["tokens"].shape) == (4, 4)
    assert {n: m.launches for n, m in mods.items()} == {
        "flash_attention": 2 * 2, "decode_attention": 2 * 2 * 3, "ssd_scan": 0, "rglru_scan": 0}
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
    (1, 200, 200, 16, 1, 256, True, 64, 0),   # Dh 256, group 16, a window that cuts keys
    (1, 130, 130, 2, 1, 160, True, 0, 0),     # Dh 160 on the Dh 256 body, zero columns
    (2, 100, 161, 4, 2, 192, True, 0, 61),    # Dh 192, ragged Sq and Skv under q_offset
    (1, 64, 64, 2, 1, 256, True, 0, -16),     # Dh 256, rows with no visible key
    (4, 1100, 1100, 16, 4, 256, True, 0, 0),  # Dh 256, 288 kv tiles: one head subset
    (2, 2112, 2112, 6, 2, 160, True, 512, 0),  # Dh 160, group 3 in subsets of 1 and 2
    (2, 300, 300, 4, 4, 80, False, 0, 0),     # bidirectional MHA at Dh 80 (hubert-xlarge)
    (2, 300, 300, 12, 2, 128, True, 0, 0),    # GQA group 6 (internvl2-26b)
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


@pytest.mark.parametrize("case", [BWD_CASES[1], BWD_CASES[2], BWD_CASES[8], BWD_CASES[-1],
                                  BWD_CASES[12], BWD_CASES[13]],
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


def test_flash_backward_plan_shared_memory_is_the_kernels(dev):
    """flash_attention_bwd.plan's dynamic shared memory of the dK/dV and the
    dQ kernel is what the library launches them with, at every head dim and
    for both dtypes."""
    import ctypes
    from repro_torch.kernels import _build, flash_attention_bwd
    lib, _ = flash_attention_bwd._fn()
    fn = lib.flash_attention_bwd_smem
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    for dtype in (torch.float32, torch.bfloat16):
        for Dh in range(16, 257, 16):
            got = (ctypes.c_int * 2)()
            assert fn(_build.DTYPE_CODES[dtype], Dh, got) == 0
            p = flash_attention_bwd.plan(4, 3072, 3072, 16, 1, Dh, dtype)
            assert tuple(got) == (p.dkdv_smem, p.dq_smem), (dtype, Dh)
            assert max(got) <= 232448  # what a block may opt in to on the H100


def test_flash_backward_refuses_head_dims_past_256(dev):
    """Dh 256 trains (recurrentgemma-9b's); past it the backward refuses, as
    the forward does."""
    from repro_torch.kernels import flash_attention_bwd, ops
    q = torch.zeros(1, 16, 2, 256, device=dev, requires_grad=True)
    k = torch.zeros(1, 16, 1, 256, device=dev, requires_grad=True)
    ops.flash_attention(q, k, k).sum().backward()
    assert q.grad is not None and k.grad is not None
    q, k = torch.zeros(1, 16, 2, 272, device=dev), torch.zeros(1, 16, 1, 272, device=dev)
    lse = torch.zeros(1, 2, 16, device=dev)
    with pytest.raises(ValueError, match="256"):
        flash_attention_bwd.flash_attention_bwd_cuda(q, k, k, q, lse, q, causal=True,
                                                     window=0, q_offset=0,
                                                     softmax_scale=272 ** -0.5)


def test_wrappers_without_a_backward_raise_under_autograd(dev):
    """decode has no backward kernel: under grad mode an input that requires
    grad must raise, not yield an output without grad."""
    from repro_torch.kernels import ops
    q = torch.zeros(1, 2, 16, device=dev, requires_grad=True)
    kc = torch.zeros(1, 8, 1, 16, device=dev)
    cl = torch.ones(1, dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="ROADMAP.md"):
        ops.decode_attention(q, kc, kc, cl)
    with torch.no_grad():
        ops.decode_attention(q, kc, kc, cl)


# B, S, W, h0, a cotangent on the final state; the plan's chunk is 64
RGLRU_BWD_CASES = [
    (2, 197, 33, True, True),     # 4 chunks, the last of 5 steps; W under one block
    (2, 63, 33, False, True),     # one chunk: the out kernel alone
    (3, 1001, 1000, True, False),  # ragged S and W, no final-state cotangent
    (1, 65, 129, False, False),   # a last chunk of one step, W one past a block
]


def _rglru_bwd_inputs(dev, case, dtype, seed=9):
    B, S, W, with_h0, with_dh = case
    x, a_log, h0 = _rglru_inputs(dev, B, S, W, with_h0, dtype, seed=seed)
    gen = torch.Generator().manual_seed(seed + 1)
    dy = _randn(gen, (B, S, W), dtype, dev)
    dh = _randn(gen, (B, W), dtype, dev) if with_dh else None
    return x, a_log, h0, dy, dh


def _rglru_grads(fn, x, a_log, h0, dy, dh):
    leaves = [t.detach().clone().requires_grad_(True) for t in (x, a_log)]
    h0l = h0.detach().clone().requires_grad_(True) if h0 is not None else None
    y, hl = fn(*leaves, h0=h0l)
    loss = (y.float() * dy.float()).sum() + ((hl.float() * dh.float()).sum()
                                             if dh is not None else 0)
    return torch.autograd.grad(loss, leaves + ([h0l] if h0l is not None else []))


@pytest.mark.parametrize("case", RGLRU_BWD_CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_backward_vs_autograd_through_the_plain_version(dev, case, dtype):
    """dx, da_log and dh0 of RGLRUScan against autograd through ref.rglru_scan:
    f32 within 1e-4 (1 + max |ref|), bf16 within a relative RMS of 2e-2 (the
    plain forward rounds only y and h_last, the kernels also dx)."""
    from repro_torch.kernels import ops, ref, rglru_scan, rglru_scan_bwd
    x, a_log, h0, dy, dh = _rglru_bwd_inputs(dev, case, dtype)
    before = (rglru_scan.launches, rglru_scan_bwd.launches, ref.calls)
    got = _rglru_grads(ops.rglru_scan, x, a_log, h0, dy, dh)
    torch.cuda.synchronize()
    assert (rglru_scan.launches, rglru_scan_bwd.launches, ref.calls) == (
        before[0] + 1, before[1] + 1, before[2])
    want = _rglru_grads(ref.rglru_scan, x, a_log, h0, dy, dh)
    assert len(got) == len(want) == (3 if h0 is not None else 2)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and bool(torch.isfinite(a).all())
        if dtype == torch.float32:
            assert float((a - b).abs().max()) <= 1e-4 * (1 + float(b.abs().max()))
        else:
            assert float((a.float() - b.float()).norm() / b.float().norm()) <= 2e-2


@pytest.mark.parametrize("case", RGLRU_BWD_CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_bwd_kernel_vs_the_plain_backward(dev, case, dtype):
    """The backward kernels alone, on the forward's own workspace, against
    ref.rglru_scan_bwd: f32 within 1e-4 (1 + max |ref|), bf16 within a
    relative RMS of 1e-2 (both compute in f32; the kernels reassociate only
    the carry into each chunk); two calls bitwise equal."""
    from repro_torch.kernels import ref, rglru_scan, rglru_scan_bwd
    x, a_log, h0, dy, dh = _rglru_bwd_inputs(dev, case, dtype, seed=11)
    _, _, ws = rglru_scan._forward(x, a_log, h0)
    got = rglru_scan_bwd.rglru_scan_bwd_cuda(x, a_log, h0, dy, dh, fwd_workspace=ws)
    again = rglru_scan_bwd.rglru_scan_bwd_cuda(x, a_log, h0, dy, dh, fwd_workspace=ws)
    want = ref.rglru_scan_bwd(x, a_log, h0, dy, dh)
    torch.cuda.synchronize()
    for a, a2, b in zip(got, again, want):
        assert (a is None) == (b is None)
        if b is None:
            continue
        assert torch.equal(a, a2) and a.dtype == b.dtype
        if dtype == torch.float32:
            assert float((a - b).abs().max()) <= 1e-4 * (1 + float(b.abs().max()))
        else:
            assert float((a.float() - b.float()).norm() / b.float().norm()) <= 1e-2


def test_rglru_bwd_kernel_with_unit_decay(dev):
    """a_log 0 on some steps (a = 1, under the clamp) and very negative on
    others (a = 0): f32 within 1e-4 (1 + max |ref|) of ref.rglru_scan_bwd."""
    from repro_torch.kernels import ref, rglru_scan, rglru_scan_bwd
    x, a_log, h0, dy, dh = _rglru_bwd_inputs(dev, (2, 197, 33, True, True), torch.float32)
    a_log[:, ::3] = 0.0
    a_log[:, 1::7] = -30.0
    _, _, ws = rglru_scan._forward(x, a_log, h0)
    got = rglru_scan_bwd.rglru_scan_bwd_cuda(x, a_log, h0, dy, dh, fwd_workspace=ws)
    want = ref.rglru_scan_bwd(x, a_log, h0, dy, dh)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-4 * (1 + float(b.abs().max()))


@pytest.mark.parametrize("W", [128, 129])
def test_rglru_bwd_kernel_over_a_long_chain_on_a_side_stream(dev, W):
    """300 chunks a row (S 64 x 300), so the look-back crosses many waves of
    blocks; W 128 stages its rows by 16-byte copies, W 129 by plain loads.
    On a side stream, against ref.rglru_scan_bwd in f32 (1e-4 (1 + max
    |ref|)), and two calls bitwise equal."""
    from repro_torch.kernels import ref, rglru_scan, rglru_scan_bwd
    x, a_log, h0, dy, dh = _rglru_bwd_inputs(dev, (2, 64 * 300, W, True, True), torch.float32)
    _, _, ws = rglru_scan._forward(x, a_log, h0)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        got = rglru_scan_bwd.rglru_scan_bwd_cuda(x, a_log, h0, dy, dh, fwd_workspace=ws)
        again = rglru_scan_bwd.rglru_scan_bwd_cuda(x, a_log, h0, dy, dh, fwd_workspace=ws)
    torch.cuda.current_stream(dev).wait_stream(side)
    want = ref.rglru_scan_bwd(x, a_log, h0, dy, dh)
    torch.cuda.synchronize(dev)
    for a, a2, b in zip(got, again, want):
        assert torch.equal(a, a2)
        assert float((a - b).abs().max()) <= 1e-4 * (1 + float(b.abs().max()))


def test_rglru_backward_plan_shared_memory_is_the_kernels(dev):
    """rglru_scan_bwd.plan's dynamic shared memory per dtype is what the
    library launches its kernel with, at every chunk length."""
    import ctypes
    from repro_torch.kernels import _build, rglru_scan_bwd
    lib, _ = rglru_scan_bwd._fn()
    fn = lib.rglru_scan_bwd_smem
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    for L in range(1, rglru_scan_bwd.MAX_CHUNK + 1):
        p = rglru_scan_bwd.plan(2, L, 129)
        assert p.chunk == L
        for dtype, want in ((torch.float32, p.smem_f32), (torch.bfloat16, p.smem_bf16)):
            got = ctypes.c_int()
            assert fn(_build.DTYPE_CODES[dtype], L, ctypes.byref(got)) == 0
            assert got.value == want <= 232448, (L, dtype)


def test_rglru_bwd_sqrt_is_bitwise_sqrtf_over_its_range(dev):
    """The backward kernel's branch-free sqrt against sqrtf at every float in
    [1e-12, 1], the range of max(1 - a^2, 1e-12) for any a: no bit differs."""
    import ctypes
    from repro_torch.kernels import rglru_scan_bwd
    lib, _ = rglru_scan_bwd._fn()
    fn = lib.rglru_scan_bwd_sqrt_check
    fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_void_p], ctypes.c_int
    bad = torch.full((1,), -1, dtype=torch.int64, device=dev)
    assert fn(bad.data_ptr(), torch.cuda.current_stream(dev).cuda_stream) == 0
    torch.cuda.synchronize(dev)
    assert int(bad.item()) == 0


def test_rglru_gradient_flows_through_the_backward_kernels(dev):
    """The RG-LRU scan under autograd gives x, a_log and h0 a gradient through
    its backward kernels, and none of the plain versions runs; without grad
    the forward runs alone."""
    from repro_torch.kernels import ops, ref, rglru_scan, rglru_scan_bwd
    x, a_log, h0 = _rglru_inputs(dev, 2, 130, 40, True, torch.float32)
    leaves = [t.requires_grad_(True) for t in (x, a_log, h0)]
    fwd, bwd, plain = rglru_scan.launches, rglru_scan_bwd.launches, ref.calls
    y, hl = ops.rglru_scan(leaves[0], leaves[1], h0=leaves[2])
    assert y.grad_fn is not None and hl.grad_fn is not None
    y.sum().backward()
    torch.cuda.synchronize()
    assert (rglru_scan.launches, rglru_scan_bwd.launches, ref.calls) == (fwd + 1, bwd + 1,
                                                                         plain)
    assert all(t.grad is not None and bool(torch.isfinite(t.grad).all()) for t in leaves)
    with torch.no_grad():
        y, _ = ops.rglru_scan(leaves[0], leaves[1], h0=leaves[2])
    assert y.grad_fn is None and rglru_scan.launches == fwd + 2


def test_ssd_gradient_flows_through_the_backward_kernels(dev):
    """The SSD scan under autograd gives every input a gradient through its
    backward kernels, and none of the plain versions runs."""
    from repro_torch.kernels import ops, ref, ssd_scan, ssd_scan_bwd
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(dev, 1, 8, 2, 8, 4, True, torch.float32)
    leaves = [t.requires_grad_(True) for t in (x, dt, A, Bm, Cm, h0)]
    fwd, bwd, plain = ssd_scan.launches, ssd_scan_bwd.launches, ref.calls
    y, hf = ops.ssd_scan(*leaves[:5], chunk=8, h0=leaves[5])
    assert y.grad_fn is not None and hf.grad_fn is not None
    y.sum().backward()
    torch.cuda.synchronize()
    assert (ssd_scan.launches, ssd_scan_bwd.launches, ref.calls) == (fwd + 1, bwd + 1, plain)
    assert all(t.grad is not None and bool(torch.isfinite(t.grad).all()) for t in leaves)
    with torch.no_grad():
        y, _ = ops.ssd_scan(*leaves[:5], chunk=8, h0=leaves[5])
    assert y.grad_fn is None and ssd_scan.launches == fwd + 2


GATHER_CASES = [
    # n_slots, slot_size, slots, lengths, out_width[, rows of the buffer before
    # the arena, which is the contiguous view that starts there]
    (64, 256, list(range(0, 64, 4)), [1, 255, 17, 256] * 4, 256),
    (64, 128, [63, 0, 5, 9, 11, 2, 3, 40], [127, 1, 64, 0, 128, 5, 90, 100], 300),
    (64, 64, list(range(32)), [i * 2 for i in range(32)], 32),
    (4, 16, [5, -1, -5, -10, 3], [16, 100, -3, 16, 8], 16),
    (4, 16, [], [], 16),
    (4096, 1518, list(range(0, 4096, 16)), [64 + 5 * i for i in range(256)], 1518),
    # 16-byte output chunks that straddle rows, partial last chunks
    (64, 8, [(7 * i) % 64 for i in range(37)], [i % 10 - 1 for i in range(37)], 1),
    (64, 9, [(5 * i) % 64 for i in range(33)], [i % 12 - 1 for i in range(33)], 15),
    (64, 40, [63 - i for i in range(33)], [(3 * i) % 45 - 2 for i in range(33)], 17),
    (4096, 1518, [(17 * i) % 4096 for i in range(255)],
     [64 + (7 * i) % 1454 for i in range(255)], 1518),      # 255 * 1518 % 16 = 2
    # the arena is buffer[1:]: its rows are off 16-byte boundaries
    (300, 1518, [(11 * i) % 300 for i in range(64)],
     [(37 * i) % 1530 - 5 for i in range(64)], 1518, 1),
    # the whole ring of 4096 slots in one call
    (4096, 1518, [(1031 * i) % 4096 for i in range(4096)],
     [64 + (13 * i) % 1454 for i in range(4096)], 1518),
]


def _gather_arena(case, dev):
    n_slots, slot_size = case[:2]
    skip = case[5] if len(case) > 5 else 0
    gen = torch.Generator().manual_seed(6)
    return torch.randint(0, 256, (skip + n_slots, slot_size), generator=gen,
                         dtype=torch.uint8).to(dev)[skip:]


@pytest.mark.parametrize("case", GATHER_CASES, ids=lambda c: f"{c[0]}x{c[1]}-n{len(c[2])}")
def test_burst_gather_kernel_vs_plain(dev, case):
    from repro_torch.kernels import burst_gather, ops, ref
    slots, lengths, width = case[2:5]
    arena = _gather_arena(case, dev)
    s = torch.tensor(slots, dtype=torch.int32, device=dev)
    n = torch.tensor(lengths, dtype=torch.int32, device=dev)
    before = burst_gather.launches
    got = ops.burst_gather(arena, s, n, width)
    torch.cuda.synchronize()
    assert burst_gather.launches == before + (1 if slots else 0)
    assert got.shape == (len(slots), width) and got.device == arena.device
    assert torch.equal(got, ref.burst_gather(arena, s, n, width))


def test_burst_gather_twice_on_a_side_stream_bitwise_equal(dev):
    """Two calls on a stream other than the default give the same bytes as
    the plain version: the launch goes to the caller's current stream."""
    from repro_torch.kernels import burst_gather, ops, ref
    case = GATHER_CASES[-3]  # a partial last chunk at 1518
    arena = _gather_arena(case, dev)
    s = torch.tensor(case[2], dtype=torch.int32, device=dev)
    n = torch.tensor(case[3], dtype=torch.int32, device=dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    before = burst_gather.launches
    with torch.cuda.stream(side):
        a, b = ops.burst_gather(arena, s, n, case[4]), ops.burst_gather(arena, s, n, case[4])
    torch.cuda.current_stream(dev).wait_stream(side)
    torch.cuda.synchronize()
    assert burst_gather.launches == before + 2
    assert torch.equal(a, b) and torch.equal(a, ref.burst_gather(arena, s, n, case[4]))


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


def test_mixtral_smoke_train_step_vs_plain_and_repeated_bitwise(dev, monkeypatch):
    """A mixtral-8x7b smoke train step in f32 (4 MoE layers, a 32-key
    window over S 40): through the flash kernels (each layer's forward and
    its recompute, one backward; no plain call) the loss within 1e-5
    relative and every gradient within 1e-4 of its largest magnitude of the
    plain versions', whose expert choices are forced to the kernels' run's
    in the same order; run again, the loss and every gradient bit-equal."""
    from repro_torch import tree
    from repro_torch.data.pipeline import DataConfig, synth_tokens
    from repro_torch.kernels import flash_attention, flash_attention_bwd, ops, ref
    from repro_torch.launch import serve
    from repro_torch.models import moe
    from repro_torch.models.registry import get_smoke_config
    from repro_torch.runtime.steps import loss_and_grads
    cfg = get_smoke_config("mixtral-8x7b").replace(param_dtype="float32",
                                                   compute_dtype="float32")
    params = serve.init_params(cfg, 0, dev)
    host = synth_tokens(cfg, DataConfig(seq_len=40, global_batch=2, seed=2), 0, 1, 0)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    route, chosen = moe.route, []

    def recorded(c, router, x2d):
        out = route(c, router, x2d)
        chosen.append(out[0])
        return out
    monkeypatch.setattr(moe, "route", recorded)
    flash_attention.launches = flash_attention_bwd.launches = ref.calls = 0
    loss, _, got = loss_and_grads(cfg, params, batch)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention_bwd.launches, ref.calls) == (8, 4, 0)
    assert len(chosen) == 2 * cfg.n_layers
    loss2, _, again = loss_and_grads(cfg, params, batch)
    assert torch.equal(loss, loss2)
    got, again = tree.leaf_paths(got), tree.leaf_paths(again)
    assert all(torch.equal(got[k], again[k]) for k in got)
    forced = iter(chosen[:2 * cfg.n_layers])

    def replayed(c, router, x2d):
        _, _, aux = route(c, router, x2d)
        idx = next(forced)
        logits = x2d.float() @ router.float()
        return idx, torch.softmax(logits.gather(1, idx), dim=-1), aux
    monkeypatch.setattr(moe, "route", replayed)
    monkeypatch.setattr(ops, "flash_attention", lambda q, k, v, **kw: ref.mha(q, k, v, **kw))
    loss_p, _, want = loss_and_grads(cfg, params, batch)
    assert abs(float(loss) - float(loss_p)) <= 1e-5 * abs(float(loss_p))
    want = tree.leaf_paths(want)
    for key in want:
        bound = 1e-4 * float(want[key].abs().max())
        assert float((got[key] - want[key]).abs().max()) <= bound, key
        if key.split("/")[-1] in ("wq", "wk", "wv", "w_gate", "router"):
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


def test_smoke_train_of_recurrentgemma_goes_through_the_kernels(dev):
    """Two recurrentgemma-9b smoke train steps (4 RG-LRU layers and 1
    attention layer): per step each layer's forward and its recompute, and
    one backward; no plain call."""
    from repro_torch.kernels import (flash_attention, flash_attention_bwd, ref, rglru_scan,
                                     rglru_scan_bwd)
    from repro_torch.launch import train
    mods = (flash_attention, flash_attention_bwd, rglru_scan, rglru_scan_bwd)
    for m in mods:
        m.launches = 0
    ref.calls = 0
    rt = train.main(["--arch", "recurrentgemma-9b", "--smoke", "--steps", "2", "--seq-len",
                     "40", "--global-batch", "2", "--log-every", "1"])
    assert tuple(m.launches for m in mods) == (4, 2, 16, 8)
    assert ref.calls == 0
    assert all(m["loss"] == m["loss"] for m in rt.metrics_log)  # finite, not NaN


def test_smoke_train_of_mamba2_goes_through_the_kernels(dev):
    """Two mamba2 smoke train steps (4 blocks): per step each block's SSD
    forward and its recompute, and one SSD backward; no plain call."""
    from repro_torch.kernels import ref, ssd_scan, ssd_scan_bwd
    from repro_torch.launch import train
    ssd_scan.launches = ssd_scan_bwd.launches = ref.calls = 0
    rt = train.main(["--arch", "mamba2-1.3b", "--smoke", "--steps", "2", "--seq-len", "32",
                     "--global-batch", "2", "--log-every", "1"])
    assert (ssd_scan.launches, ssd_scan_bwd.launches) == (16, 8)
    assert ref.calls == 0
    assert all(m["loss"] == m["loss"] for m in rt.metrics_log)  # finite, not NaN


def test_mixtral_moe_layer_bf16_vs_f32_at_full_width(dev):
    """One MoE layer at mixtral-8x7b's full width (8 experts of 4096 x 14336,
    top-2) on 2048 tokens, bf16 against the same layer in f32 (TF32 off).
    The router's logits are f32 products of the same bf16-exact inputs in
    both, so they route alike and the aux losses are equal; the outputs
    differ by the bf16 rounding of the expert products, summed over 4096 and
    14336 terms: each token's output within a relative RMS of 2e-2 of the
    f32 one and the whole within 1e-2, where a wrong expert, slot or weight
    moves a token's output by order 100%."""
    from repro_torch.configs.mixtral_8x7b import CONFIG
    from repro_torch.models import moe
    cfg = CONFIG.replace(n_layers=1)
    p = moe.init_moe_layer(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    x = _randn(torch.Generator().manual_seed(1), (4, 512, cfg.d_model), torch.bfloat16, dev)
    got, aux = moe.apply_moe(cfg, p, x)
    idx, _, _ = moe.route(cfg, p["router"], x.reshape(-1, cfg.d_model))
    c32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    p32 = {k: v.float() for k, v in p.items()}
    want, aux32 = moe.apply_moe(c32, p32, x.float())
    idx32, _, _ = moe.route(c32, p32["router"], x.float().reshape(-1, cfg.d_model))
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert torch.equal(idx, idx32)
    assert float(aux) == float(aux32)
    diff = (got.float() - want).reshape(-1, cfg.d_model)
    per_token = diff.norm(dim=-1) / want.reshape(-1, cfg.d_model).norm(dim=-1)
    assert float(per_token.max()) <= 2e-2
    assert float(diff.norm() / want.norm()) <= 1e-2


# -- the simulator's epoch pass (exact: integer arithmetic) -------------------

def _epoch_inputs(n, dev, seed=0, n_flows=256, queues=8):
    gen = torch.Generator().manual_seed(seed)
    gaps = torch.randint(0, 250, (n,), generator=gen) * torch.randint(0, 2, (n,), generator=gen)
    handed = torch.cumsum(gaps, 0)
    ser = torch.randint(5, 250, (n,), generator=gen)
    table = torch.randint(0, queues, (n_flows,), generator=gen)
    fids = torch.randint(-n_flows, n_flows, (n,), generator=gen)  # negative ids wrap
    busy0 = int(handed[n // 2]) if n else 3
    return [t.to(dev) for t in (handed, ser, table, fids)], busy0


def _same_pass(got, want):
    """Two passes' outputs (tensors anywhere, or numpy) bit-equal."""
    (a, busy, q), (wa, wbusy, wq) = got, want
    assert torch.equal(torch.as_tensor(a).cpu(), torch.as_tensor(wa).cpu()) and busy == wbusy
    assert (q is None) == (wq is None)
    if q is not None:
        assert torch.equal(torch.as_tensor(q).cpu(), torch.as_tensor(wq).cpu())


@pytest.mark.parametrize("n", [0, 1, 8, 511, 512, 513, 1025, 2047, 2048, 2049, 4097, 63343,
                               1 << 20])
@pytest.mark.parametrize("steer", [True, False])
def test_epoch_pass_kernel_vs_plain_and_numpy(dev, n, steer):
    from repro_torch.kernels import epoch_pass, ops, ref
    (h, s, table, fids), busy0 = _epoch_inputs(n, dev, seed=n)
    t, f = (table, fids) if steer else (None, None)
    before = epoch_pass.launches
    got = ops.epoch_pass(h, s, busy0, 1000, t, f)
    assert epoch_pass.launches == before + (1 if n else 0)
    assert got[0].is_cuda and (got[2] is None) == (not steer)
    _same_pass(got, ref.epoch_pass(h, s, busy0, 1000, t, f))
    host = [None if x is None else x.cpu().numpy() for x in (h, s, t, f)]
    _same_pass(got, epoch_pass.epoch_pass_np(host[0], host[1], busy0, 1000, host[2], host[3]))
    _same_pass(ops.epoch_pass(h, s, busy0, 1000, t, f), got)  # repeat calls equal


def test_epoch_pass_tile_is_the_plans(dev):
    from repro_torch.kernels import _build, epoch_pass
    assert _build.load("epoch_pass").epoch_pass_tile() == epoch_pass.TILE == 512


def _numpy_pass(h, s, busy0, lat, t, f):
    from repro_torch.kernels import epoch_pass
    host = [None if x is None else x.cpu().numpy() for x in (h, s, t, f)]
    return epoch_pass.epoch_pass_np(host[0], host[1], busy0, lat, host[2], host[3])


def test_epoch_pass_consecutive_calls_of_mixed_sizes(dev):
    """n growing and shrinking on the device's one workspace (flags of
    earlier, larger calls left in place): every call bit-equal to numpy,
    through the wrapper and through make_pass."""
    from repro_torch.kernels import epoch_pass, ops
    engine = epoch_pass.make_pass("cuda")
    for k, n in enumerate((1 << 16, 1, 63343, 2049, 1 << 16, 513)):
        (h, s, table, fids), busy0 = _epoch_inputs(n, dev, seed=100 + k)
        want = _numpy_pass(h, s, busy0, 1000, table, fids)
        _same_pass(ops.epoch_pass(h, s, busy0, 1000, table, fids), want)
        host = [x.cpu().numpy() for x in (h, s, table, fids)]
        _same_pass(engine(host[0], host[1], busy0, 1000, host[2], host[3]), want)


def test_epoch_pass_unaligned_inputs(dev):
    """Inputs that start 8 bytes past a 16-byte boundary take the kernel's
    8-byte loads and stores."""
    from repro_torch.kernels import ops
    n = 5000
    (h, s, table, fids), busy0 = _epoch_inputs(n + 1, dev, seed=9)
    h, s, fids = h[1:], s[1:], fids[1:]
    assert h.data_ptr() % 16 == 8 and h.is_contiguous()
    got = ops.epoch_pass(h, s, busy0, 7, table, fids)
    assert got[0].data_ptr() % 16 == 0
    _same_pass(got, _numpy_pass(h, s, busy0, 7, table, fids))


def test_epoch_make_pass_returns_fresh_arrays(dev):
    """The engine keeps every array the pass returns: the next call, which
    reuses the staging buffers, leaves them as they were."""
    import numpy as np
    from repro_torch.kernels import epoch_pass
    engine = epoch_pass.make_pass("cuda")
    (h, s, table, fids), busy0 = _epoch_inputs(4097, dev, seed=5)
    host = [x.cpu().numpy() for x in (h, s, table, fids)]
    first = engine(host[0], host[1], busy0, 1000, host[2], host[3])
    kept = [first[0].copy(), first[2].copy()]
    engine(host[0][::-1].copy(), host[1], 0, 3, host[2], host[3][::-1].copy())
    assert np.array_equal(first[0], kept[0]) and np.array_equal(first[2], kept[1])
    # strided slices, as the engine hands a two-port run's, need no copy first
    two = np.repeat(host[0], 2)[::2]
    assert not two.flags.c_contiguous
    _same_pass(engine(two, host[1], busy0, 1000, host[2], host[3]),
               epoch_pass.epoch_pass_np(two, host[1], busy0, 1000, host[2], host[3]))


def test_epoch_pass_out_of_range_flow_id_raises(dev):
    from repro_torch.kernels import epoch_pass, ops
    (h, s, table, fids), _ = _epoch_inputs(5000, dev)
    fids[4321] = 256
    with pytest.raises(IndexError):
        ops.epoch_pass(h, s, 0, 0, table, fids)
    fids[4321] = 3  # the status word is reset by the next call
    assert ops.epoch_pass(h, s, 0, 0, table, fids)[2].shape == (5000,)
    host = [x.cpu().numpy() for x in (h, s, table, fids)]
    engine = epoch_pass.make_pass("cuda")
    host[3][17] = -257
    with pytest.raises(IndexError):
        engine(host[0], host[1], 0, 0, host[2], host[3])
    host[3][17] = -256
    _same_pass(engine(host[0], host[1], 0, 0, host[2], host[3]),
               _numpy_pass(h, s, 0, 0, table, torch.from_numpy(host[3])))


def test_epoch_engine_on_the_card_matches_numpy_engine(dev):
    """run_epoch_sim(device="cuda") on tests/test_fastpath.py's two-port
    config: the numpy engine's RunReport and clock, one launch an epoch."""
    from repro_torch.core import fastpath, loadgen, packet, pmd, simclock
    from repro_torch.kernels import epoch_pass, ref

    def run(device):
        pools = [packet.PacketPool(8192, 2048) for _ in range(2)]
        ports = [pmd.Port.make(pool, ring_size=1024, writeback_threshold=32, n_queues=4,
                               link_gbps=40.0, link_latency_ns=1000) for pool in pools]
        server = pmd.BypassL2FwdServer(ports, burst_size=64, n_lcores=8)
        clock = simclock.SimClock()
        server.attach_clock(clock)
        info = fastpath.EpochRunInfo()
        rep = fastpath.run_epoch_sim(loadgen.LoadGen(ports), server,
                                     loadgen.TrafficPattern(rate_gbps=40.0, packet_size=1518),
                                     duration_s=0.002, clock=clock, device=device, info=info,
                                     epoch_ns=100_000)
        return rep.to_dict(), clock.now_ns, info

    want = run(None)
    launches, calls = epoch_pass.launches, ref.calls
    got = run("cuda")
    assert got[2].fastpath and got[2].engine == "epoch-torch" and got[2].pass_device == "cuda"
    assert got[:2] == want[:2]
    assert epoch_pass.launches - launches == got[2].n_epochs >= 20 and ref.calls == calls


# -- the experiment layer: run_experiment with the pass on the card -----------

def _experiment_on_card(cfg):
    """run_experiment with the numpy pass, then with the kernel on "cuda":
    both reports and the kernel's launches."""
    from repro_torch.exp import run_experiment
    from repro_torch.kernels import epoch_pass, ref
    want = run_experiment(cfg.with_traffic(engine="epoch")).to_dict()
    launches, calls = epoch_pass.launches, ref.calls
    got = run_experiment(cfg.with_traffic(engine="epoch-torch"), device="cuda").to_dict()
    assert ref.calls == calls
    return want, got, epoch_pass.launches - launches


def test_fig3a_search_on_the_card_matches_numpy(dev):
    """Fig. 3a's bypass search at one port (benchmarks/common.py's msb):
    24.8 Gbit/s under both engines, the kernel launched on the fast path."""
    from repro_torch.exp import (ExperimentConfig, PoolConfig, PortConfig, StackConfig,
                                 TrafficConfig)
    cfg = ExperimentConfig(
        name="bench", pool=PoolConfig(n_slots=16384, slot_size=1518),
        ports=(PortConfig(n_queues=1, ring_size=1024, writeback_threshold=32),),
        stack=StackConfig(kind="bypass", burst_size=64),
        traffic=TrafficConfig(mode="msb", trial_s=0.004, start_gbps=0.1, refine_iters=4))
    want, got, launched = _experiment_on_card(cfg)
    assert got == want and want["extras"]["msb_gbps"] == 24.8
    assert launched > 0


def test_fig4_dca_on_the_card_matches_numpy(dev):
    """Fig. 4's burst-1024 DCA config (benchmarks/fig4_dca_burst.py): the
    writeback timers keep it on the event loop under both engines, with
    equal reports and no launch."""
    from repro_torch.exp import (DcaConfig, ExperimentConfig, PortConfig, StackConfig,
                                 TrafficConfig)
    cfg = ExperimentConfig(
        name="fig4-burst-1024", ports=(PortConfig(n_queues=1, ring_size=2048),),
        stack=StackConfig(kind="bypass", n_lcores=1),
        traffic=TrafficConfig(mode="open_loop", rate_gbps=10.0, packet_size=1518,
                              duration_s=0.004, seed=3),
        dca=DcaConfig(burst_size=1024, writeback_threshold=32, writeback_timeout_ns=200_000))
    want, got, launched = _experiment_on_card(cfg)
    assert got == want and want["received"] == want["sent"] > 0
    assert launched == 0
