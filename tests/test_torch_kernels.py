"""The port's attention entry points on the CPU against the JAX package.

``repro_torch.kernels.ops`` on CPU tensors runs the plain PyTorch versions;
they are held against the Pallas kernels in interpret mode and against the
JAX package's chunked path, on the same inputs drawn from a numpy seed.
Tolerances are those of tests/test_kernels.py: 2e-5 for f32, 2e-2 for bf16.
The CUDA kernels themselves run only on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.kernels import ops as jops
from repro.kernels.decode_attention import decode_attention_pallas
from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels import decode_attention as tdecode
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops, ref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}

FLASH_CASES = [
    # B, Sq, Skv, H, Hkv, Dh, causal, window, q_offset
    (1, 128, 128, 2, 2, 64, True, 0, 0),      # group 1
    (2, 256, 256, 4, 2, 16, True, 0, 0),      # group 2, Dh 16
    (1, 256, 256, 4, 1, 64, False, 0, 0),     # bidirectional, group 4
    (1, 384, 384, 2, 1, 16, True, 128, 0),    # sliding window
    (1, 100, 100, 4, 2, 64, True, 0, 0),      # ragged S, causal
    (1, 200, 200, 2, 1, 16, False, 0, 0),     # ragged S, bidirectional (kv padding)
    (2, 64, 192, 4, 2, 128, True, 0, 128),    # q_offset: a later prompt chunk
    (1, 96, 160, 8, 2, 128, True, 64, 64),    # q_offset + window, group 4
    (2, 128, 128, 8, 2, 128, True, 0, 0),     # Dh 128, group 4
]


def _np_qkv(seed, B, Sq, Skv, H, Hkv, Dh):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, Dh), dtype=np.float32),
            rng.standard_normal((B, Skv, Hkv, Dh), dtype=np.float32),
            rng.standard_normal((B, Skv, Hkv, Dh), dtype=np.float32))


def _jax(x, dtype):
    return jnp.asarray(x, getattr(jnp, dtype))


def _torch(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_vs_pallas(case, dtype):
    B, Sq, Skv, H, Hkv, Dh, causal, window, q_offset = case
    q, k, v = _np_qkv(1, B, Sq, Skv, H, Hkv, Dh)
    want = flash_attention_pallas(_jax(q, dtype), _jax(k, dtype), _jax(v, dtype),
                                  causal=causal, window=window, q_offset=q_offset,
                                  blk_q=128, blk_k=128, interpret=True)
    got = ops.flash_attention(_torch(q, dtype), _torch(k, dtype), _torch(v, dtype),
                              causal=causal, window=window, q_offset=q_offset)
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, Sq, H, Dh)
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_plain_vs_chunked(case):
    B, Sq, Skv, H, Hkv, Dh, causal, window, q_offset = case
    q, k, v = _np_qkv(2, B, Sq, Skv, H, Hkv, Dh)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal=causal, window=window, q_offset=q_offset,
                                impl="chunked", q_chunk=64)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal, window=window,
                              q_offset=q_offset)
    _close(got, want, TOL["float32"])


def test_flash_plain_fully_masked_rows_are_zero():
    """A negative q_offset leaves the first rows with no visible key: they
    give 0, as the reference's jnp.where(isnan) does."""
    q, k, v = _np_qkv(3, 1, 32, 32, 2, 1, 16)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=True, q_offset=-8)
    assert torch.isfinite(got).all()
    assert torch.count_nonzero(got[:, :8]) == 0
    assert torch.count_nonzero(got[:, 8:]) > 0


DECODE_CASES = [
    # B, C, H, Hkv, Dh, cache_len
    (4, 300, 4, 2, 64, (0, 1, 300, 157)),     # ragged C, empty and full rows
    (3, 128, 6, 3, 16, (128, 0, 77)),         # group 2, Dh 16
    (2, 544, 16, 8, 128, (544, 513)),         # qwen3-1.7b heads, serve cache size
    (2, 200, 8, 2, 128, (1, 200)),            # group 4
]


@pytest.mark.parametrize("case", DECODE_CASES, ids=lambda c: "-".join(map(str, c[:5])))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_vs_pallas(case, dtype):
    B, C, H, Hkv, Dh, lens = case
    rng = np.random.default_rng(4)
    q = rng.standard_normal((B, H, Dh), dtype=np.float32)
    kc = rng.standard_normal((B, C, Hkv, Dh), dtype=np.float32)
    vc = rng.standard_normal((B, C, Hkv, Dh), dtype=np.float32)
    cl = np.asarray(lens, np.int32)
    want = decode_attention_pallas(_jax(q, dtype), _jax(kc, dtype), _jax(vc, dtype),
                                   jnp.asarray(cl), blk_k=128, interpret=True)
    got = ops.decode_attention(_torch(q, dtype), _torch(kc, dtype),
                               _torch(vc, dtype), torch.from_numpy(cl))
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, H, Dh)
    _close(got, want, TOL[dtype])
    empty = [i for i, n in enumerate(lens) if n == 0]
    assert torch.count_nonzero(got[empty]) == 0


def test_decode_plain_vs_jax_ops():
    """Against the JAX package's own dispatch on the CPU (its plain path)."""
    B, C, H, Hkv, Dh = 3, 96, 4, 2, 32
    rng = np.random.default_rng(5)
    q = rng.standard_normal((B, H, Dh), dtype=np.float32)
    kc = rng.standard_normal((B, C, Hkv, Dh), dtype=np.float32)
    vc = rng.standard_normal((B, C, Hkv, Dh), dtype=np.float32)
    cl = np.asarray([96, 5, 0], np.int32)
    want = jops.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                 jnp.asarray(cl), impl="chunked")
    got = ops.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                               torch.from_numpy(vc), torch.from_numpy(cl))
    _close(got, want, TOL["float32"])


def test_cpu_tensors_take_the_plain_version():
    q, k, v = _np_qkv(6, 1, 16, 16, 2, 1, 16)
    launches = (tflash.launches, tdecode.launches)
    calls = ref.calls
    ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    ops.decode_attention(torch.from_numpy(q[:, 0]), torch.from_numpy(k),
                         torch.from_numpy(v), torch.tensor([16], dtype=torch.int32))
    assert ref.calls == calls + 2
    assert (tflash.launches, tdecode.launches) == launches


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel wrappers never run a CPU tensor (nor build anything for it)."""
    q, k, v = (torch.from_numpy(a) for a in _np_qkv(7, 1, 16, 16, 2, 1, 16))
    with pytest.raises(ValueError, match="CUDA"):
        tflash.flash_attention_cuda(q, k, v, causal=True, window=0, q_offset=0,
                                    softmax_scale=0.25)
    with pytest.raises(ValueError, match="CUDA"):
        tdecode.decode_attention_cuda(q[:, 0], k, v, torch.tensor([16], dtype=torch.int32),
                                      softmax_scale=0.25)


def test_ops_raise_on_mixed_devices():
    q = torch.zeros(1, 4, 2, 16)
    k = torch.zeros(1, 4, 1, 16, device="meta")
    with pytest.raises(ValueError, match="mixed"):
        ops.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="mixed"):
        ops.decode_attention(q[:, 0], k, k, torch.zeros(1, dtype=torch.int32))
