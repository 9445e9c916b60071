"""The SSD backward kernels' operand split, on the CPU.

The kernels ``ssd_bwd_scores``, ``ssd_bwd_dbc_part`` and ``ssd_bwd_dx``
(``csrc/ssd_scan_bwd.cu``) take their products on the tensor cores in bf16:
in a bf16 call each f32 operand (h_c, g_{c+1}, L∘S) as bf16 hi + lo and the
raw bf16 inputs as they are; in an f32 call every operand in three bf16
parts. ``ref.ssd_scan_bwd(..., split=dtype)`` mirrors that rounding. Here:

* the mirror against ``jax.vjp`` of the JAX package's chunked SSD on
  ``test_torch_ssd_bwd.py``'s cases, within the same 1e-4 of each
  gradient's largest magnitude, for the f32 kernels' split and for the bf16
  kernels' (inputs rounded to bf16 values, carried in f32 on both sides,
  so that only the products' rounding differs);
* the split itself: |a − hi − lo| ≤ 2⁻¹⁶·|a| (and three parts within 2⁻²⁴)
  on normal, wide-range, zero and bf16-exact values, lo exactly 0 for a
  bf16-exact a.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ref

from test_torch_ssd_bwd import CASES, GRAD_OF_MAX, NAMES, _assert_close, _inputs

RAW = ("x", "Bm", "Cm", "dy")  # the inputs the bf16 kernels take as they are


def _bf16_valued(a):
    return {k: (torch.from_numpy(v).to(torch.bfloat16).float().numpy()
                if k in RAW else v) for k, v in a.items()}


@pytest.mark.parametrize("split", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_split_mirror_matches_jax_vjp_of_the_chunked_ssd(case, split):
    chunk, with_h0 = case[5], case[6]
    a = _inputs(case, seed=2)
    if split == torch.bfloat16:
        a = _bf16_valued(a)
    names = ("x", "dt", "A", "Bm", "Cm") + (("h0",) if with_h0 else ())

    def fwd(*args):
        kw = dict(zip(names, args))
        return jops.ssd_scan(kw["x"], kw["dt"], kw["A"], kw["Bm"], kw["Cm"], chunk=chunk,
                             h0=kw.get("h0"), impl="chunked")
    (_, hf), vjp = jax.vjp(fwd, *(jnp.asarray(a[k]) for k in names))
    dh = a["dh"] if a["dh"] is not None else np.zeros(hf.shape, np.float32)
    want = vjp((jnp.asarray(a["dy"]), jnp.asarray(dh)))
    t = {k: (torch.from_numpy(v) if v is not None else None) for k, v in a.items()}
    got = ref.ssd_scan_bwd(t["x"], t["dt"], t["A"], t["Bm"], t["Cm"], t["h0"], t["dy"],
                           t["dh"], chunk=chunk, split=split)
    plain = ref.ssd_scan_bwd(t["x"], t["dt"], t["A"], t["Bm"], t["Cm"], t["h0"], t["dy"],
                             t["dh"], chunk=chunk)
    for name, g, w in zip(NAMES, got, want):
        _assert_close(name, g, w)
    # the mirror rounds: it is not the plain f32 backward to the last bit
    assert any(not torch.equal(g, p) for g, p in zip(got[:5], plain[:5]))


@pytest.mark.parametrize("kind", ["normal", "wide", "zero", "bf16_exact"])
def test_split_bf16_is_within_two_to_the_minus_16(kind):
    rng = np.random.default_rng(3)
    n = 1 << 16
    if kind == "normal":
        a = rng.standard_normal(n)
    elif kind == "wide":  # 1e-30 to 1e30, either sign
        a = 10.0 ** rng.uniform(-30, 30, n) * rng.choice([-1.0, 1.0], n)
    elif kind == "zero":
        a = np.zeros(n)
    else:
        a = torch.from_numpy(rng.standard_normal(n) * 1e3).to(torch.bfloat16).double().numpy()
    a = torch.from_numpy(a.astype(np.float32))
    for parts, bound in ((2, 2.0 ** -16), (3, 2.0 ** -24)):
        got = ref.split_bf16(a, parts)
        assert len(got) == parts
        err = (a.double() - sum(p.double() for p in got)).abs()
        assert bool((err <= bound * a.double().abs()).all()), (parts, float(err.max()))
        for p in got:
            assert p.dtype == torch.float32 and torch.equal(p, p.to(torch.bfloat16).float())
        if kind in ("zero", "bf16_exact"):
            assert torch.equal(got[0], a) and all(bool((p == 0).all()) for p in got[1:])
