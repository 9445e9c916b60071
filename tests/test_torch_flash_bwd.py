"""The plain flash backward (``ref.mha_bwd``) on the CPU against the JAX package.

``ref.mha_bwd`` is the gradient that the backward kernel
(``csrc/flash_attention_bwd.cu``) computes, from the forward's saved output
and logsumexp. The JAX package has no backward kernel: it differentiates its
chunked path (``repro.kernels.ops.flash_attention(..., impl="chunked")``,
checkpointed per query chunk). Both take the same inputs, drawn from a numpy
seed, in f32, and must agree within 1e-4 (1 + max |ref|) elementwise, the
f32 bound the backward kernel is held to on the card. The two compute the
same function in another order of f32 sums, and alone they agree within
5.2e-7 (1 + max |ref|); but inside a whole parallel test run the CPU f32 path
of ``ref.mha_bwd`` has, on rare occasions, come out 2.2e-5 (1 + max |ref|)
from a float64 reference where JAX stayed within 1.4e-7, so 1e-5 would make
the test flaky. It shows only under load, and no setting of the process
(threads, matmul precision, oneDNN, denormals, the file run before) brings it
back: ROADMAP.md Queue 3 keeps it open. A wrong mask, scale or product moves
a gradient by 1e-2 or more. The same bound holds ``ref.mha_bwd`` against autograd through
``ref.mha``. The CUDA kernel itself runs only on the card
(tests/test_torch_cuda.py, chip_smoke.py), where it is held against
``ref.mha_bwd``.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ref

TOL = 1e-4

CASES = [
    # B, Sq, Skv, H, Hkv, Dh, causal, window, q_offset
    (1, 64, 64, 2, 2, 32, True, 0, 0),        # causal
    (1, 96, 96, 4, 2, 16, True, 24, 0),       # a window over several 16-key tiles
    (1, 40, 40, 16, 1, 16, True, 0, 0),       # GQA group 16
    (2, 24, 56, 4, 2, 32, True, 0, 32),       # q_offset > 0, Sq != Skv
    (1, 25, 41, 2, 1, 16, True, 0, 16),       # ragged Sq and Skv under q_offset
    (1, 48, 48, 2, 1, 80, True, 0, 0),        # Dh 80
    (1, 36, 52, 4, 2, 32, False, 0, 0),       # not causal
    (1, 48, 48, 16, 1, 256, True, 20, 0),     # Dh 256, group 16, a window that cuts keys
]


def _np_inputs(seed, case):
    B, Sq, Skv, H, Hkv, Dh = case[:6]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, Dh), dtype=np.float32)
    k = rng.standard_normal((B, Skv, Hkv, Dh), dtype=np.float32)
    v = rng.standard_normal((B, Skv, Hkv, Dh), dtype=np.float32)
    dout = rng.standard_normal((B, Sq, H, Dh), dtype=np.float32)
    return q, k, v, dout


def _saved(q, k, v, *, causal, window, q_offset, scale):
    """What the forward kernel saves: the output and the logsumexp of the
    scaled, masked scores (B, H, Sq), +inf on a row with no visible key."""
    B, Sq, H, Dh = q.shape
    Hkv = k.shape[2]
    out = ref.mha(q, k, v, causal=causal, window=window, q_offset=q_offset,
                  softmax_scale=scale)
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.reshape(B, Sq, Hkv, H // Hkv, Dh), k) * scale
    mask = ref.attention_mask(Sq, k.shape[1], causal=causal, window=window,
                              q_offset=q_offset)
    lse = torch.logsumexp(s.masked_fill(~mask, float("-inf")), -1).reshape(B, H, Sq)
    return out, torch.where(torch.isinf(lse), torch.inf, lse)


def _plain_bwd(q, k, v, dout, **mask):
    t = [torch.from_numpy(a) for a in (q, k, v, dout)]
    out, lse = _saved(*t[:3], **mask)
    return ref.mha_bwd(*t[:3], out, lse, t[3], causal=mask["causal"], window=mask["window"],
                       q_offset=mask["q_offset"], softmax_scale=mask["scale"])


def _close(got, want):
    want = np.asarray(want, np.float32)
    got = got.numpy()
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= TOL * (1 + float(np.abs(want).max()))


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_plain_backward_vs_jax_grad_of_chunked(case):
    causal, window, q_offset = case[6:]
    scale = case[5] ** -0.5
    q, k, v, dout = _np_inputs(1, case)

    def f(q_, k_, v_):
        return jops.flash_attention(q_, k_, v_, causal=causal, window=window,
                                    q_offset=q_offset, softmax_scale=scale, impl="chunked",
                                    q_chunk=16)
    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(dout))
    got = _plain_bwd(q, k, v, dout, causal=causal, window=window, q_offset=q_offset,
                     scale=scale)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, w)


@pytest.mark.parametrize("case", CASES + [(1, 32, 32, 2, 1, 16, True, 0, -8)],
                         ids=lambda c: "-".join(map(str, c)))
def test_plain_backward_vs_autograd_through_plain_forward(case):
    """Also on a case whose first rows see no key: there the JAX package's
    chunked path (masking with -1e30, so a uniform softmax) differs from
    ref.mha (0), so only ref.mha's gradient holds them, and their dq is 0."""
    causal, window, q_offset = case[6:]
    scale = case[5] ** -0.5
    q, k, v, dout = _np_inputs(2, case)
    got = _plain_bwd(q, k, v, dout, causal=causal, window=window, q_offset=q_offset,
                     scale=scale)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = ref.mha(*leaves, causal=causal, window=window, q_offset=q_offset,
                  softmax_scale=scale)
    want = torch.autograd.grad(out, leaves, torch.from_numpy(dout))
    for g, w in zip(got, want):
        _close(g, w)
    if q_offset < 0:
        assert torch.count_nonzero(got[0][:, :-q_offset]) == 0
        assert torch.count_nonzero(got[0][:, -q_offset:]) > 0


def test_plain_backward_keeps_the_dtype_and_counts_its_calls():
    case = (1, 32, 32, 2, 1, 16, True, 0, 0)
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in _np_inputs(3, case)]
    out, lse = _saved(*(x.float() for x in t[:3]), causal=True, window=0, q_offset=0,
                      scale=0.25)
    calls = ref.calls
    grads = ref.mha_bwd(*t[:3], out.to(torch.bfloat16), lse, t[3], causal=True,
                        softmax_scale=0.25)
    assert ref.calls == calls + 1
    assert [g.dtype for g in grads] == [torch.bfloat16] * 3
    assert [g.shape for g in grads] == [x.shape for x in t[:3]]
    assert all(bool(torch.isfinite(g).all()) for g in grads)
