"""The RG-LRU scan's gradient on the CPU: the plain backward, mirrors of the
backward kernel's sequential fold and of its look-back, its plan and ticket
order, and the autograd.Function.

* ``ref.rglru_scan_bwd`` (the closed form the CUDA backward computes) against
  ``jax.vjp`` of the JAX package's associative scan
  (``repro.kernels.ops.rglru_scan(..., impl="chunked")``, whose final state
  is its output's last row) with random cotangents on y and on the final
  state, and against ``torch.autograd`` through the port's sequential
  ``ref.rglru_scan``. Inputs from numpy with a seed, f32. The three compute
  the same function in another order of f32 operations. dx and dh0 agree
  within 1e-5 of their largest magnitude. da_log does not have such a flat
  bound, and both the port's and JAX's are held, element by element, to a
  float64 oracle of the closed form on the same f32 inputs (``_oracle``),
  within a bound derived from the conditioning of h_{t-1} - a x / s:

  - a = exp(a_log) carries each package's f32 exp error, up to
    ``EXP_ULPS`` ulps, a relative delta_a <= EXP_ULPS 2^-23 (the two
    packages' exps differ in the last bit on about a tenth of the elements;
    each stays within EXP_ULPS / 2 ulps of exp on these inputs and on a
    sweep of a_log, a test below);
  - u = 1 - a^2 then carries an absolute error a^2 (2 delta_a + eps), eps =
    2^-24, so its relative error is r_u = kappa (2 delta_a + eps) + eps with
    kappa = a^2 / (1 - a^2): about 730 at a_log = -6.9e-4, the smallest
    |a_log| of the seed-0 inputs, where kappa turns one ulp of exp into
    1e-4 of u;
  - s = sqrt(u) halves it, r_s = r_u / 2 + eps, and T = a x / s carries
    delta_a + r_s + a few eps;
  - h_{t-1} and g_t carry the errors of a and s through their recurrences
    (to first order the same whatever the order of evaluation), plus
    2 eps of rounding a step over the absolute-value recurrences, for as
    many steps as the port's sequential loop or JAX's combine tree (depth
    2 ceil(log2 S)) can put between an input and an output;
  - da_log = a g (h_{t-1} - T) sums these to first order (``_oracle``
    writes each term). At the smallest |a_log| the kappa term leads: one
    ulp of exp moves da_log there by about 5e-6 of its largest, two ulps on
    either side by more than 1e-5, the flat bound this replaces. The first
    order holds while r_u is small; every case's largest r_u is asserted
    below 0.05.

  The oracle anchors each package alone, so their difference is held to the
  sum of the two bounds. Cases: ragged S, h0 and the final-state
  cotangent each given and not, and rows of a_log = 0, where a = 1 and
  1 - a^2 falls under the clamp's 1e-12, so the gradient takes the clamp's
  constant side. The float64 oracle and these bounds need no JAX: run on
  another host with ``-k oracle``.
* A plain f32 mirror of the kernel's arithmetic (written in this file and on
  no path of the port), on the plan's chunks and the forward's entering
  states: each chunk's reverse decay product and local carry, the carries
  folded right to left, each chunk's states recomputed from the state
  entering it and its steps in reverse. Its sequential form (the carries
  folded in chunk order) is held against ``ref.rglru_scan_bwd`` within 1e-5
  of each gradient's largest. Its look-back form finishes each chunk's fold
  from the carry of a chunk further right, one chosen for every chunk (each
  one, and random choices from a seed), as the kernel's blocks do wherever
  their look-back stops: its carries, dx, da_log and dh0 are bitwise the
  sequential form's, and within 1e-5 of ``ref.rglru_scan_bwd`` and of
  ``jax.vjp`` of the associative scan (da_log within the derived bound of
  the oracle, as the plain backward is).
* ``rglru_scan_bwd.plan``: blocks, workspace, flags and shared memory worked
  out by hand from the note at the top of ``csrc/rglru_scan_bwd.cu``, at the
  train shape and at the grid edges, and its refusals;
  ``rglru_scan_bwd.ticket_work``: every (b, chunk, tile) draws one ticket, and
  the chunks to a chunk's right draw lower ones.
* ``rglru_scan.RGLRUScan`` with its two kernel calls replaced by the plain
  versions: what it saves, what it hands the backward and what it returns.
  The kernels themselves run on the card only (``tests/test_torch_cuda.py``,
  ``chip_smoke.py``).
"""
import ast
import inspect
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels import rglru_scan as trglru
from repro_torch.kernels import rglru_scan_bwd as tbwd
from repro_torch.models.registry import get_config

GRAD_OF_MAX = 1e-5
NAMES = ("dx", "da_log", "dh0")
EPS = 2.0 ** -24   # f32 unit roundoff
EXP_ULPS = 2       # how far each package's f32 exp may be from exp, in ulps
DELTA_A = EXP_ULPS * 2.0 ** -23  # as a relative error: an ulp is <= 2^-23 of a float
R_U_MAX = 0.05     # the first-order analysis holds while 1 - a^2 is known to 5%

# B, S, W, h0, a cotangent on the final state, rows of a_log = 0
CASES = [
    (2, 37, 33, True, True, False),     # ragged S and W
    (2, 64, 16, False, True, False),    # no h0
    (1, 50, 24, True, False, False),    # no final-state cotangent
    (2, 1, 8, True, True, False),       # S 1
    (1, 130, 20, False, False, False),  # neither: only y has a cotangent
    (2, 45, 16, True, True, True),      # a_log = 0 on some rows: the clamp
]


def _inputs(case, seed=0):
    B, S, W, with_h0, with_dh, zero_rows = case
    rng = np.random.default_rng(seed)
    a = dict(x=rng.standard_normal((B, S, W), dtype=np.float32),
             a_log=(-np.abs(rng.standard_normal((B, S, W))) * 0.5).astype(np.float32),
             dy=rng.standard_normal((B, S, W), dtype=np.float32))
    if zero_rows:
        a["a_log"][:, ::3] = 0.0  # every third step of every channel: a = 1
    a["h0"] = rng.standard_normal((B, W), dtype=np.float32) if with_h0 else None
    a["dh"] = rng.standard_normal((B, W), dtype=np.float32) if with_dh else None
    return a


def _torch(a):
    return {k: (torch.from_numpy(v) if v is not None else None) for k, v in a.items()}


def _plain_bwd(a):
    t = _torch(a)
    return ref.rglru_scan_bwd(t["x"], t["a_log"], t["h0"], t["dy"], t["dh"])


def _assert_close(name, got, want):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, (name, got.shape, want.shape)
    bound = GRAD_OF_MAX * max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= bound, f"{name}: max abs diff {err} > {bound}"


def _jax_vjp(a):
    """(dx, da_log[, dh0]) of jax.vjp of the JAX package's associative scan on
    the inputs ``a``, a zero final-state cotangent where none is given. JAX
    is imported here, so that the oracle's tests run where it is missing."""
    import jax
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    x, a_log = jnp.asarray(a["x"]), jnp.asarray(a["a_log"])
    dh = a["dh"] if a["dh"] is not None else np.zeros_like(a["x"][:, 0])
    if a["h0"] is not None:
        _, vjp = jax.vjp(lambda x, al, h0: jops.rglru_scan(x, al, h0=h0, impl="chunked"),
                         x, a_log, jnp.asarray(a["h0"]))
    else:
        _, vjp = jax.vjp(lambda x, al: jops.rglru_scan(x, al, impl="chunked"), x, a_log)
    return vjp((jnp.asarray(a["dy"]), jnp.asarray(dh)))


def _oracle(a, t_scale=1.0):
    """The closed form in float64 on the f32 inputs ``a`` and, element by
    element, the first-order bound on an f32 evaluation's distance from it
    (the derivation is in the docstring at the top): ((dx, da_log, dh0),
    (their bounds), the largest r_u of the steps off the clamp). dh0 and
    its bound are None where h0 is. ``t_scale`` scales the a x / s term of
    the returned da_log (not its bound), to make a wrong gradient."""
    x, lam, dy = (a[k].astype(np.float64) for k in ("x", "a_log", "dy"))
    B, S, W = x.shape
    A = np.exp(lam)
    u = 1.0 - A * A
    # f32 and float64 clamp the same steps: exactly those with a_log = 0
    clamp = u < 1e-12
    assert np.array_equal(clamp, a["a_log"] == 0)
    s = np.sqrt(np.maximum(u, 1e-12))
    r_u = np.where(clamp, 0.0, A * A * (2 * DELTA_A + EPS) / np.where(clamp, 1.0, u) + EPS)
    r_s = r_u / 2 + EPS
    depth = 2 * math.ceil(math.log2(max(S, 2))) + 2  # JAX's combine tree, and slack
    zeros = np.zeros((B, W))
    h0 = a["h0"].astype(np.float64) if a["h0"] is not None else zeros
    # forward: h_{t-1}, its error from a and s, and the absolute recurrence
    h, e, habs = h0, zeros, np.abs(h0)
    H, E_h = np.empty_like(x), np.empty_like(x)
    for t in range(S):
        H[:, t] = h
        E_h[:, t] = e + 2 * EPS * (t + depth) * habs
        b = s[:, t] * x[:, t]
        e = A[:, t] * e + A[:, t] * np.abs(h) * DELTA_A + np.abs(b) * (r_s[:, t] + EPS)
        h = A[:, t] * h + b
        habs = A[:, t] * habs + np.abs(b)
    # reverse: g, its error from a, and the absolute recurrence
    g = a["dh"].astype(np.float64) if a["dh"] is not None else zeros
    e, gabs = zeros, np.abs(g)
    G, E_g = np.empty_like(x), np.empty_like(x)
    for t in reversed(range(S)):
        g, gabs = dy[:, t] + g, np.abs(dy[:, t]) + gabs
        G[:, t] = g
        E_g[:, t] = e + 2 * EPS * (S - t + depth) * gabs
        e = A[:, t] * e + A[:, t] * np.abs(g) * DELTA_A
        g, gabs = A[:, t] * g, A[:, t] * gabs
    T = np.where(clamp, 0.0, A * x / s)
    D = H - T
    E_D = E_h + np.abs(T) * (DELTA_A + r_s + 6 * EPS) + EPS * (np.abs(H) + np.abs(T))
    b_da = (A * np.abs(G) * E_D + A * np.abs(D) * E_g
            + np.abs(A * G * D) * (DELTA_A + 3 * EPS))
    da_log = A * G * (H - t_scale * T)
    dx = s * G
    b_dx = s * E_g + np.abs(dx) * (r_s + 2 * EPS)
    dh0 = A[:, 0] * G[:, 0]
    b_dh0 = A[:, 0] * E_g[:, 0] + np.abs(dh0) * (DELTA_A + EPS)
    if a["h0"] is None:
        dh0 = b_dh0 = None
    return (dx, da_log, dh0), (b_dx, b_da, b_dh0), float(r_u.max())


def _assert_within(name, got, want, bound):
    """|got - want| <= bound, element by element."""
    got = np.asarray(got.detach() if torch.is_tensor(got) else got, np.float64)
    err = np.abs(got - want)
    worst = np.unravel_index(np.argmax(err - bound), err.shape)
    assert (err <= bound).all(), (f"{name}: at {worst}, |diff| {err[worst]} > bound "
                                  f"{bound[worst]} ({(err > bound).sum()} of {err.size} "
                                  f"elements outside; got {got[worst]!r}, want "
                                  f"{want[worst]!r})")


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_plain_backward_matches_jax_vjp_of_the_associative_scan(case):
    """dx and dh0 within 1e-5 of their largest; da_log of each package within
    the derived bound of the float64 oracle, and of each other within the
    sum of the two bounds."""
    a = _inputs(case)
    want = _jax_vjp(a)
    got = _plain_bwd(a)
    exact, bounds, r_u = _oracle(a)
    assert r_u < R_U_MAX
    assert (got[2] is None) == (a["h0"] is None)
    for name, g, w, e, b in zip(NAMES, got, want, exact, bounds):
        _assert_within(f"port {name} vs oracle", g, e, b)
        _assert_within(f"JAX {name} vs oracle", np.asarray(w), e, b)
        if name == "da_log":
            _assert_within(f"port {name} vs JAX", g, np.asarray(w, np.float64), 2 * b)
        else:
            _assert_close(name, g, w)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_plain_backward_matches_autograd_through_the_plain_forward(case):
    a = _inputs(case, seed=1)
    t = _torch(a)
    leaves = [t["x"].clone().requires_grad_(True), t["a_log"].clone().requires_grad_(True)]
    h0 = t["h0"].clone().requires_grad_(True) if t["h0"] is not None else None
    y, hl = ref.rglru_scan(*leaves, h0=h0)
    loss = (y * t["dy"]).sum() + ((hl * t["dh"]).sum() if t["dh"] is not None else 0)
    want = torch.autograd.grad(loss, leaves + ([h0] if h0 is not None else []))
    got = _plain_bwd(a)
    for name, g, w in zip(NAMES, got, want):
        _assert_close(name, g, w.numpy())


def test_plain_backward_at_a_log_zero_takes_the_clamps_constant_side():
    """Where a = 1 the gate is the constant 1e-6: dx = 1e-6 g, and da_log =
    g h_{t-1}, with no term from the gate."""
    a = _inputs((1, 6, 4, True, False, False), seed=2)
    a["a_log"][:] = 0.0
    t = _torch(a)
    dx, da_log, dh0 = ref.rglru_scan_bwd(t["x"], t["a_log"], t["h0"], t["dy"], None)
    g = t["dy"].flip(1).cumsum(1).flip(1)  # a = 1: g_t = sum of dy from t on
    h_prev = torch.cat([t["h0"][:, None], (t["h0"][:, None]
                                           + 1e-6 * t["x"].cumsum(1))[:, :-1]], 1)
    torch.testing.assert_close(dx, 1e-6 * g, rtol=1e-5, atol=0)
    torch.testing.assert_close(da_log, g * h_prev, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(dh0, g[:, 0])


def test_plain_backward_rounds_dx_to_the_input_dtype():
    a = _torch(_inputs(CASES[0], seed=3))
    x = a["x"].to(torch.bfloat16)
    dx, da_log, dh0 = ref.rglru_scan_bwd(x, a["a_log"], a["h0"], a["dy"].to(torch.bfloat16),
                                         a["dh"].to(torch.bfloat16))
    assert (dx.dtype, da_log.dtype, dh0.dtype) == (torch.bfloat16, torch.float32,
                                                   torch.float32)


@pytest.mark.parametrize("seed", [0, 1, 4, 5])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_plain_backward_within_the_derived_bound_of_the_float64_oracle(case, seed):
    """The port alone against the oracle, on the seeds of this file's tests
    and one more: dx, da_log and dh0 within their bounds (no JAX: this runs
    on any host)."""
    a = _inputs(case, seed=seed)
    exact, bounds, r_u = _oracle(a)
    assert r_u < R_U_MAX
    for name, g, e, b in zip(NAMES, _plain_bwd(a), exact, bounds):
        assert (g is None) == (e is None)
        if g is not None:
            _assert_within(name, g, e, b)


@pytest.mark.parametrize("package", ["torch", "jax"])
def test_exp_within_the_ulps_the_bound_allows(package):
    """Each package's f32 exp within EXP_ULPS / 2 ulps of float64's exp, on
    every case's a_log (the seeds of this file's tests) and on 200 001
    values over [-20, 0]: the bound's delta_a with a factor 2 to spare."""
    if package == "jax":
        import jax.numpy as jnp
        exp = lambda v: np.asarray(jnp.exp(jnp.asarray(v)))  # noqa: E731
    else:
        exp = lambda v: torch.exp(torch.from_numpy(v)).numpy()  # noqa: E731
    values = [_inputs(c, seed)["a_log"] for c in CASES for seed in (0, 1, 4, 5)]
    values.append(-np.linspace(0, 20, 200_001, dtype=np.float32))
    for v in values:
        got = exp(v)
        ulps = np.abs(got - np.exp(v.astype(np.float64))) / np.spacing(got)
        assert float(ulps.max()) <= EXP_ULPS / 2, (package, float(ulps.max()))


def test_oracle_bound_catches_a_wrong_gradient():
    """The derived bound is tight enough to matter: da_log with its a x / s
    term 0.1% off falls outside it, and where a is not near 1 the bound is
    far under the flat 1e-5 of the largest that it replaces."""
    a = _inputs(CASES[0])
    (_, da_log, _), bounds, _ = _oracle(a)
    (_, wrong, _), _, _ = _oracle(a, t_scale=1.001)
    assert (np.abs(wrong - da_log) > bounds[1]).any()
    far = a["a_log"] < -0.01
    assert np.median(bounds[1][far]) < GRAD_OF_MAX * np.abs(da_log).max() / 10


# --------------------------------------------------------------------------
# mirrors of the backward kernel: the sequential fold and the look-back
# --------------------------------------------------------------------------

def _fold(p, g, e):
    """The carry a chunk hands its left neighbour: its decay product p times
    the carry g from its right, plus its local carry e."""
    return p * g + e


def _parts(x, a_log, h0, dy, L):
    """What the kernel works out per chunk before any carry is known: the
    steps' a, 1 - a^2 and gate, the chunks' bounds, the forward's states
    entering each chunk (its workspace after its pass), and each chunk's
    reverse decay product and local carry from the carry 0 (chunk 0's are
    never used)."""
    B, S, W = x.shape
    nc = -(-S // L)
    a = torch.exp(a_log)
    u = 1.0 - a * a
    s = torch.sqrt(torch.clamp_min(u, 1e-12))
    zeros = torch.zeros((B, W))
    bounds = [(c * L, min((c + 1) * L, S)) for c in range(nc)]
    h = h0 if h0 is not None else zeros
    enter = []
    for lo, hi in bounds:
        enter.append(h)
        for t in range(lo, hi):
            h = a[:, t] * h + s[:, t] * x[:, t]
    prod, local = [None] * nc, [None] * nc
    for c in range(1, nc):
        G, p = zeros, torch.ones((B, W))
        for t in reversed(range(*bounds[c])):
            G = a[:, t] * (dy[:, t] + G)
            p = p * a[:, t]
        prod[c], local[c] = p, G
    return dict(a=a, u=u, s=s, bounds=bounds, enter=enter, prod=prod, local=local)


def _out(x, dy, h0, parts, carry):
    """Each chunk's states forward from the state entering it, then its steps
    in reverse from the carry into it: (dx, da_log, dh0)."""
    a, u, s = parts["a"], parts["u"], parts["s"]
    dx, da_log = torch.empty_like(x), torch.empty_like(x)
    for c, (lo, hi) in enumerate(parts["bounds"]):
        h, h_prev = parts["enter"][c], {}
        for t in range(lo, hi):
            h_prev[t] = h
            h = a[:, t] * h + s[:, t] * x[:, t]
        G = carry[c]
        for t in reversed(range(lo, hi)):
            g = dy[:, t] + G
            dh_da = torch.where(u[:, t] >= 1e-12, h_prev[t] - a[:, t] * x[:, t] / s[:, t],
                                h_prev[t])
            dx[:, t] = s[:, t] * g
            da_log[:, t] = a[:, t] * g * dh_da
            G = a[:, t] * g
        if c == 0:
            dh0 = G  # the chunk-0 block writes dh0 from the carry it ends with
    return dx, da_log, dh0 if h0 is not None else None


def _last_carry(x, dh):
    return dh if dh is not None else torch.zeros((x.shape[0], x.shape[2]))


def sequential_carries(parts, last):
    """The carries into each chunk from its right, folded right to left."""
    nc = len(parts["bounds"])
    carry = [None] * nc
    carry[nc - 1] = last
    for c in range(nc - 1, 0, -1):
        carry[c - 1] = _fold(parts["prod"][c], carry[c], parts["local"][c])
    return carry


def lookback_carries(parts, last, choose):
    """The carries as the kernel's blocks find them, chunks in ticket order
    (last first): chunk c's block stops its look-back at chunk choose(c) > c,
    starts from the carry that block published (this mirror's own, not the
    sequential one's) and folds the chunks between, innermost first."""
    nc = len(parts["bounds"])
    carry = [None] * nc
    carry[nc - 1] = last
    for c in range(nc - 2, -1, -1):
        j = choose(c)
        assert c < j < nc
        G = carry[j]
        for i in range(j, c, -1):
            G = _fold(parts["prod"][i], G, parts["local"][i])
        carry[c] = G
    return carry


def mirror(x, a_log, h0, dy, dh, L, choose=None):
    """The kernel's arithmetic in f32 over chunks of L steps (the last may be
    shorter): its carries folded in chunk order (``choose`` None) or by the
    look-back from the chunks ``choose`` picks. Returns ((dx, da_log, dh0),
    the carries into each chunk)."""
    parts = _parts(x, a_log, h0, dy, L)
    last = _last_carry(x, dh)
    carry = (sequential_carries(parts, last) if choose is None
             else lookback_carries(parts, last, choose))
    return _out(x, dy, h0, parts, carry), carry


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("L", [None, 7, 16])  # the plan's chunk, and shorter ones
def test_mirror_of_the_kernels_matches_the_plain_backward(case, L):
    a = _inputs(case, seed=4)
    t = _torch(a)
    B, S, W = case[:3]
    chunk = tbwd.plan(B, S, W).chunk if L is None else min(L, S)
    got, _ = mirror(t["x"], t["a_log"], t["h0"], t["dy"], t["dh"], chunk)
    want = _plain_bwd(a)
    assert (got[2] is None) == (want[2] is None)
    for name, g, w in zip(NAMES, got, want):
        if w is not None:
            _assert_close(name, g, w.numpy())


def _chunk(case, L):
    B, S, W = case[:3]
    return tbwd.plan(B, S, W).chunk if L is None else min(L, S)


def _chooser(kind, nc):
    """Where each chunk's look-back stops: its right neighbour, the last
    chunk, or a chunk drawn from a seed."""
    if kind == "nearest":
        return lambda c: c + 1
    if kind == "last":
        return lambda c: nc - 1
    rng = np.random.default_rng(int(kind.split("-")[1]))
    return lambda c: int(rng.integers(c + 1, nc))


LOOKBACK_KINDS = ["nearest", "last", "seed-0", "seed-1", "seed-2"]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("L", [None, 7, 16])
def test_the_fold_from_every_chunk_to_the_right_gives_the_sequential_carry(case, L):
    """Chunk c's carry folded from the carry of every chunk j > c, through
    the aggregates of chunks j .. c + 1, is bitwise the sequential carry."""
    t = _torch(_inputs(case, seed=4))
    parts = _parts(t["x"], t["a_log"], t["h0"], t["dy"], _chunk(case, L))
    carry = sequential_carries(parts, _last_carry(t["x"], t["dh"]))
    nc = len(carry)
    for c in range(nc - 1):
        for j in range(c + 1, nc):
            G = carry[j]
            for i in range(j, c, -1):
                G = _fold(parts["prod"][i], G, parts["local"][i])
            assert torch.equal(G, carry[c]), (c, j)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("L", [None, 7, 16])
@pytest.mark.parametrize("kind", LOOKBACK_KINDS)
def test_lookback_mirror_is_bitwise_the_sequential_mirror(case, L, kind):
    t = _torch(_inputs(case, seed=4))
    chunk = _chunk(case, L)
    args = (t["x"], t["a_log"], t["h0"], t["dy"], t["dh"], chunk)
    want, want_carry = mirror(*args)
    got, carry = mirror(*args, choose=_chooser(kind, len(want_carry)))
    assert all(torch.equal(g, w) for g, w in zip(carry, want_carry))
    assert (got[2] is None) == (want[2] is None)
    for name, g, w in zip(NAMES, got, want):
        if w is not None:
            assert torch.equal(g, w), name


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("L", [None, 7, 16])
def test_lookback_mirror_matches_the_plain_backward_and_jax_vjp(case, L):
    """On the inputs the plain backward is held against jax.vjp with."""
    a = _inputs(case)
    t = _torch(a)
    chunk = _chunk(case, L)
    nc = -(-case[1] // chunk)
    got, _ = mirror(t["x"], t["a_log"], t["h0"], t["dy"], t["dh"], chunk,
                    choose=_chooser("seed-0", nc))
    exact, bounds, _ = _oracle(a)
    for want in (_plain_bwd(a), _jax_vjp(a)):
        assert (got[2] is None) == (len(want) < 3 or want[2] is None)
        for name, g, w, b in zip(NAMES, got, want, bounds):
            if w is None:
                continue
            w = np.asarray(w.detach() if torch.is_tensor(w) else w)
            if name == "da_log":
                _assert_within(name, g, w.astype(np.float64), 2 * b)
            else:
                _assert_close(name, g, w)


# --------------------------------------------------------------------------
# the plan
# --------------------------------------------------------------------------

# (B, S, W) -> (L, chunks, tiles, blocks, threads, workspace floats, flag
# words, shared memory f32, bf16): one block per (b, chunk, 32-channel tile);
# P and E of chunks 1 .. nc - 1; their carries out (two words each), an
# aggregate flag a tile and the ticket counter; a, H, dy and x of L steps and
# 32 channels
PLANS = {
    # recurrentgemma-9b train: 4 rows of 3072, 24576 blocks, 24 KB a bf16 block
    (4, 3072, 4096): (64, 48, 128, 24576, 128, 1540096, 1564161, 32768, 24576),
    (3, 1001, 1000): (64, 16, 32, 1536, 128, 90000, 91441, 32768, 24576),  # last chunk 41
    (2, 7, 33): (7, 1, 2, 4, 128, 0, 1, 3584, 2688),                      # S < L: one chunk
    (2, 1, 33): (1, 1, 2, 4, 128, 0, 1, 512, 384),                        # S 1
    (2, 63, 33): (63, 1, 2, 4, 128, 0, 1, 32256, 24192),                  # S = L - 1
    (2, 64, 33): (64, 1, 2, 4, 128, 0, 1, 32768, 24576),                  # S = L
    (2, 65, 33): (64, 2, 2, 8, 128, 132, 137, 32768, 24576),              # S = L + 1
    (2, 197, 129): (64, 4, 5, 40, 128, 1548, 1579, 32768, 24576),         # W one past 4 tiles
    (65535, 64, 128): (64, 1, 4, 262140, 128, 0, 1, 32768, 24576),        # most rows
    # 65535 chunks of 64: the longest S the backward takes
    (1, 64 * 65535, 1): (64, 65535, 1, 65535, 128, 131068, 196603, 32768, 24576),
}


@pytest.mark.parametrize("shape", list(PLANS), ids=lambda s: "-".join(map(str, s)))
def test_backward_plan_grids_and_workspace(shape):
    p = tbwd.plan(*shape)
    assert tuple(p) == PLANS[shape]
    B, S, W = shape
    fp = trglru.plan(B, S, W)
    assert (p.chunk, p.n_chunks) == (fp.chunk, fp.n_chunks)  # the forward's chunks
    assert p.workspace_floats == 2 * B * (p.n_chunks - 1) * W == fp.workspace_floats
    assert p.flag_words == 2 * B * (p.n_chunks - 1) * W + B * p.tiles * (p.n_chunks - 1) + 1
    assert p.blocks == B * p.n_chunks * p.tiles <= tbwd.MAX_BLOCKS
    assert p.n_chunks <= trglru.MAX_GRID_YZ
    assert max(p.smem_f32, p.smem_bf16) <= 232448  # what a block may opt in to on the H100


def test_backward_plan_at_the_train_shape_follows_the_config():
    cfg = get_config("recurrentgemma-9b")
    p = tbwd.plan(4, 3072, cfg.lru_width or cfg.d_model)
    assert tuple(p) == PLANS[(4, 3072, 4096)]
    assert p.chunk <= tbwd.MAX_CHUNK


@pytest.mark.parametrize("shape", [(0, 8, 8), (1, 0, 8), (1, 8, 0), (65536, 8, 8),
                                   (1, 64 * 65535 + 1, 1)])
def test_backward_plan_refuses_what_the_kernels_cannot_take(shape):
    """The forward's bounds, and S past 64 * 65535 steps, where the forward's
    chunk grows past the 64 steps a block holds in shared memory."""
    with pytest.raises(ValueError, match="rglru_scan"):
        tbwd.plan(*shape)


# plans whose tickets are enumerated here: the train shape, ragged S and W, one
# chunk, a last chunk of one step, and the most chunks a row takes
TICKET_SHAPES = [(4, 3072, 4096), (3, 1001, 1000), (2, 7, 33), (2, 65, 33), (2, 197, 129),
                 (1, 64 * 65535, 1)]


@pytest.mark.parametrize("shape", TICKET_SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_every_block_of_the_grid_draws_exactly_one_ticket(shape):
    p = tbwd.plan(*shape)
    work = sorted(tbwd.ticket_work(p, t) for t in range(p.blocks))
    assert work == [(b, c, i) for b in range(shape[0]) for c in range(p.n_chunks)
                    for i in range(p.tiles)]


@pytest.mark.parametrize("shape", TICKET_SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_the_chunks_to_a_chunks_right_hold_lower_tickets(shape):
    """So a block's look-back waits only on blocks that have started: its
    right neighbour's ticket is lower, and so, by the same step, is every
    chunk's further right."""
    p = tbwd.plan(*shape)
    ticket = {tbwd.ticket_work(p, t): t for t in range(p.blocks)}
    for (b, c, i), t in ticket.items():
        if c + 1 < p.n_chunks:
            assert ticket[(b, c + 1, i)] < t
        else:
            assert t < shape[0] * p.tiles  # every row's last chunk before any other


def test_backward_argtypes_match_the_c_entry():
    src = (Path(tbwd.__file__).parent / "csrc" / "rglru_scan_bwd.cu").read_text()
    params = re.search(r'extern "C" int rglru_scan_bwd\(([^)]*)\)', src).group(1).split(",")
    kinds = []
    for param in params:
        param = " ".join(param.split())
        kinds.append("c_void_p" if "*" in param else {"int": "c_int"}[param.rsplit(" ", 1)[0]])
    assert kinds == [t.__name__ for t in tbwd.ARGTYPES]
    assert f"constexpr int kMaxL = {tbwd.MAX_CHUNK};" in src
    assert f"constexpr int NTB = {tbwd.BLOCK_THREADS};" in src
    assert f"constexpr int NC = {tbwd.TILE};" in src


def test_the_backward_wrapper_never_syncs_with_the_host():
    tree = ast.parse(inspect.getsource(tbwd))
    called = {n.func.attr for n in ast.walk(tree)
              if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)}
    assert not called & {"item", "synchronize", "tolist", "cpu", "numpy"}


def test_backward_wrapper_refuses_cpu_tensors():
    t = _torch(_inputs(CASES[0]))
    with pytest.raises(ValueError, match="CUDA"):
        tbwd.rglru_scan_bwd_cuda(t["x"], t["a_log"], t["h0"], t["dy"], t["dh"],
                                 fwd_workspace=torch.zeros(0))


# --------------------------------------------------------------------------
# the autograd.Function, its kernels replaced by the plain versions
# --------------------------------------------------------------------------

@pytest.fixture
def plain_kernels(monkeypatch):
    """RGLRUScan with ``_forward`` and ``rglru_scan_bwd_cuda`` on the plain
    versions; records what the backward was handed."""
    seen = {}

    def forward(x, a_log, h0):
        y, hl = ref.rglru_scan(x, a_log, h0=h0)
        return y, hl, torch.full((3,), 7.0)  # a workspace the backward must be handed

    def backward(x, a_log, h0, dy, dh_last, *, fwd_workspace):
        seen.update(ws=fwd_workspace, dh_last=dh_last, dy=dy)
        return ref.rglru_scan_bwd(x, a_log, h0, dy, dh_last)
    monkeypatch.setattr(trglru, "_forward", forward)
    monkeypatch.setattr(tbwd, "rglru_scan_bwd_cuda", backward)
    return seen


@pytest.mark.parametrize("case", [CASES[0], CASES[1]], ids=["h0", "no-h0"])
def test_rglru_scan_function_gradients_and_saved_workspace(plain_kernels, case):
    a = _torch(_inputs(case, seed=5))
    leaves = [a["x"].clone().requires_grad_(True), a["a_log"].clone().requires_grad_(True)]
    h0 = a["h0"].clone().requires_grad_(True) if a["h0"] is not None else None
    want_leaves = [t.detach().clone().requires_grad_(True) for t in leaves]
    want_h0 = h0.detach().clone().requires_grad_(True) if h0 is not None else None
    y, hl = trglru.RGLRUScan.apply(*leaves, h0)
    got = torch.autograd.grad((y * a["dy"]).sum() + (hl * a["dh"]).sum(),
                              leaves + ([h0] if h0 is not None else []))
    yw, hw = ref.rglru_scan(*want_leaves, h0=want_h0)
    want = torch.autograd.grad((yw * a["dy"]).sum() + (hw * a["dh"]).sum(),
                               want_leaves + ([want_h0] if want_h0 is not None else []))
    assert torch.equal(plain_kernels["ws"], torch.full((3,), 7.0))
    assert torch.equal(plain_kernels["dh_last"], a["dh"])
    assert len(got) == len(want) == (3 if h0 is not None else 2)
    for name, g, w in zip(NAMES, got, want):
        _assert_close(name, g, w.numpy())


def test_rglru_scan_function_makes_no_zeros_for_an_unused_final_state(plain_kernels):
    a = _torch(_inputs(CASES[1], seed=6))
    x = a["x"].requires_grad_(True)
    y, _ = trglru.RGLRUScan.apply(x, a["a_log"], None)
    (dx,) = torch.autograd.grad(y.sum(), [x])
    assert plain_kernels["dh_last"] is None  # training's case: the final state unused
    want = ref.rglru_scan_bwd(x.detach(), a["a_log"], None, torch.ones_like(x), None)[0]
    assert torch.equal(dx, want)


def test_rglru_scan_function_takes_a_final_state_cotangent_alone(plain_kernels):
    """Only h_last used: dy is handed over as zeros."""
    a = _torch(_inputs(CASES[0], seed=7))
    x = a["x"].requires_grad_(True)
    _, hl = trglru.RGLRUScan.apply(x, a["a_log"], a["h0"])
    (dx,) = torch.autograd.grad((hl * a["dh"]).sum(), [x])
    assert torch.count_nonzero(plain_kernels["dy"]) == 0
    want = ref.rglru_scan_bwd(x.detach(), a["a_log"], a["h0"], torch.zeros_like(x),
                              a["dh"])[0]
    assert torch.equal(dx, want)


def test_rglru_scan_cuda_takes_the_function_only_under_autograd(plain_kernels, monkeypatch):
    calls = []
    monkeypatch.setattr(trglru.RGLRUScan, "apply",
                        staticmethod(lambda *a: calls.append(a) or ("y", "h")))
    a = _torch(_inputs(CASES[0]))
    x = a["x"].requires_grad_(True)
    assert trglru.rglru_scan_cuda(x, a["a_log"], h0=a["h0"]) == ("y", "h")
    with torch.no_grad():
        y, _ = trglru.rglru_scan_cuda(x, a["a_log"], h0=a["h0"])
    assert len(calls) == 1 and y.shape == x.shape and y.grad_fn is None
