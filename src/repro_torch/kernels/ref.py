"""Plain PyTorch versions of the kernels: attention, the Mamba-2 SSD scan,
the RG-LRU scan, the packet burst gather and the simulator's epoch pass.

The attention functions compute what ``repro.kernels.ref`` computes, in f32,
materialising the whole score matrix; ``mha_bwd`` is ``mha``'s gradient from
the forward's saved output and logsumexp, as the backward kernel takes them
(the JAX package differentiates its chunked path instead). ``ssd_scan`` is
the JAX package's chunked form (``repro.kernels.ops.ssd_scan``),
``ssd_sequential`` its sequential oracle, ``rglru_scan`` a sequential f32
loop and ``rglru_scan_bwd`` its gradient in closed form (the JAX package
differentiates its associative scan instead), ``burst_gather`` copies
``repro.kernels.ref.burst_gather`` with the index semantics of JAX's
``arena[slots]``, and ``epoch_pass`` is
``epoch_pass_np`` (``kernels/epoch_pass.py``) in torch. The CPU takes them in ``ops``; on
the card they are what ``chip_smoke.py`` holds each CUDA kernel against.
``calls`` counts every call so a run can show that serving did not use them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

calls = 0


def attention_mask(s_q: int, s_kv: int, *, causal: bool, window: int = 0,
                   q_offset: int = 0, device=None) -> torch.Tensor:
    """(s_q, s_kv) boolean mask. window>0 limits lookback (sliding/local)."""
    qpos = torch.arange(s_q, device=device)[:, None] + q_offset
    kpos = torch.arange(s_kv, device=device)[None, :]
    mask = torch.ones((s_q, s_kv), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window and window > 0:
        mask &= kpos > qpos - window
    return mask


def _masked_softmax(scores: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    scores = scores.masked_fill(~valid, float("-inf"))
    p = torch.softmax(scores, dim=-1)
    return torch.nan_to_num(p, nan=0.0)  # fully-masked rows → 0


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, window: int = 0, q_offset: int = 0,
        softmax_scale: Optional[float] = None) -> torch.Tensor:
    """GQA attention. q (B,Sq,H,Dh), k/v (B,Skv,Hkv,Dh) → (B,Sq,H,Dh)."""
    global calls
    calls += 1
    B, Sq, H, Dh = q.shape
    Hkv = k.shape[2]
    group = H // Hkv
    scale = softmax_scale if softmax_scale is not None else Dh ** -0.5
    qg = q.reshape(B, Sq, Hkv, group, Dh).float()
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    mask = attention_mask(Sq, k.shape[1], causal=causal, window=window,
                          q_offset=q_offset, device=q.device)
    p = _masked_softmax(scores, mask[None, None, None])
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(B, Sq, H, Dh).to(q.dtype)


def mha_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
            lse: torch.Tensor, dout: torch.Tensor, *, causal: bool = True, window: int = 0,
            q_offset: int = 0, softmax_scale: Optional[float] = None
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of ``mha`` from what its forward saved, with the backward
    kernel's signature: q, out, dout (B,Sq,H,Dh), k/v (B,Skv,Hkv,Dh), lse
    (B,H,Sq) the natural-log logsumexp of the scaled, masked scores (+inf on
    a row with no visible key) → (dq, dk, dv) in q's dtype, computed in f32:
    P = exp(s·QKᵀ − lse) on the mask, D = rowsum(dO·O), dS = P·(dO Vᵀ − D),
    dV = Pᵀ dO, dK = s·dSᵀ Q, dQ = s·dS K."""
    global calls
    calls += 1
    B, Sq, H, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    group = H // Hkv
    scale = softmax_scale if softmax_scale is not None else Dh ** -0.5
    qg = q.reshape(B, Sq, Hkv, group, Dh).float()
    dog = dout.reshape(B, Sq, Hkv, group, Dh).float()
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf) * scale
    mask = attention_mask(Sq, Skv, causal=causal, window=window, q_offset=q_offset,
                          device=q.device)
    lse_g = lse.float().reshape(B, Hkv, group, Sq, 1)
    p = torch.exp(s - lse_g).masked_fill(~mask, 0.0)
    d = (dout.float() * out.float()).sum(-1)                     # (B, Sq, H)
    d = d.reshape(B, Sq, Hkv, group).permute(0, 2, 3, 1)[..., None]
    ds = p * (torch.einsum("bqhgd,bkhd->bhgqk", dog, vf) - d)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dog)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg) * scale
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf).reshape(B, Sq, H, Dh) * scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                     softmax_scale: Optional[float] = None, return_lse: bool = False):
    """One query token per row. q (B,H,Dh), caches (B,C,Hkv,Dh), cache_len (B,)
    valid prefix length → (B,H,Dh); with ``return_lse`` also the logsumexp
    (B,H) f32 of the scaled scores over the valid slots, taken in float64
    (-inf on a row with no valid slot)."""
    global calls
    calls += 1
    B, H, Dh = q.shape
    C, Hkv = k_cache.shape[1], k_cache.shape[2]
    group = H // Hkv
    scale = softmax_scale if softmax_scale is not None else Dh ** -0.5
    qg = q.reshape(B, Hkv, group, Dh).float()
    scores = torch.einsum("bhgd,bshd->bhgs", qg, k_cache.float()) * scale
    valid = (torch.arange(C, device=q.device)[None]
             < cache_len.to(q.device)[:, None])  # (B, C)
    p = _masked_softmax(scores, valid[:, None, None])
    out = torch.einsum("bhgs,bshd->bhgd", p, v_cache.float()).reshape(B, H, Dh).to(q.dtype)
    if not return_lse:
        return out
    s64 = torch.einsum("bhgd,bshd->bhgs", qg.double(), k_cache.double()) * scale
    lse = torch.logsumexp(s64.masked_fill(~valid[:, None, None], float("-inf")), dim=-1)
    return out, lse.reshape(B, H).float()


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bmat: torch.Tensor,
             Cmat: torch.Tensor, *, chunk: int, h0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked Mamba-2 SSD. x (B,S,H,P), dt (B,S,H) > 0, A (H,) < 0, Bmat and
    Cmat (B,S,N) (one group), h0 (B,H,P,N) or None → (y (B,S,H,P) in x's
    dtype, final state (B,H,P,N) f32). Any S: the tail is padded with dt = 0
    rows, which leave the state as it is. A bf16 x rounds the dot inputs to
    bf16 as the JAX package does; sums and decays stay f32."""
    global calls
    calls += 1
    Bb, S, H, P = x.shape
    N = Bmat.shape[-1]
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bmat = F.pad(Bmat, (0, 0, 0, pad))
        Cmat = F.pad(Cmat, (0, 0, 0, pad))
    nc = (S + pad) // Q
    xf = x.float().reshape(Bb, nc, Q, H, P)
    dtf = dt.float().reshape(Bb, nc, Q, H)
    Bf = Bmat.float().reshape(Bb, nc, Q, N)
    Cf = Cmat.float().reshape(Bb, nc, Q, N)
    if x.dtype == torch.bfloat16:
        def rnd(t):
            return t.to(torch.bfloat16).float()
    else:
        def rnd(t):
            return t

    dA = dtf * A.float()                                   # (B, nc, Q, H)
    xdt = xf * dtf[..., None]
    cs = dA.cumsum(2)
    csh = cs.transpose(2, 3)                               # (B, nc, H, Q)
    tri = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    L = torch.exp((csh[..., :, None] - csh[..., None, :]).masked_fill(~tri, float("-inf")))
    scores = torch.einsum("bcqn,bckn->bcqk", rnd(Cf), rnd(Bf))
    w = rnd(L * scores[:, :, None])                        # (B, nc, H, Q, Q)
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", w, rnd(xdt))

    decay_to_end = torch.exp(cs[:, :, -1:] - cs)           # (B, nc, Q, H)
    s_chunk = torch.einsum("bcqn,bcqhp->bchpn", rnd(Bf), rnd(xdt * decay_to_end[..., None]))
    chunk_decay = torch.exp(cs[:, :, -1])                  # (B, nc, H)
    h = (h0.float() if h0 is not None
         else torch.zeros((Bb, H, P, N), dtype=torch.float32, device=x.device))
    h_enter = []
    for c in range(nc):
        h_enter.append(h)
        h = chunk_decay[:, c, :, None, None] * h + s_chunk[:, c]
    y_inter = torch.einsum("bcqn,bcqh,bchpn->bcqhp", Cf, torch.exp(cs),
                           torch.stack(h_enter, 1))
    y = (y_intra + y_inter).reshape(Bb, nc * Q, H, P)[:, :S].to(x.dtype)
    return y, h


def split_bf16(a: torch.Tensor, parts: int = 2) -> Tuple[torch.Tensor, ...]:
    """f32 ``a`` as ``parts`` bf16-valued f32 tensors, each the bf16 rounding
    of what the ones before it leave of ``a`` (exact in f32): hi = bf16(a),
    lo = bf16(a − hi), so that |a − hi − lo| ≤ 2⁻¹⁶·|a|, and a third part
    brings that to about 2⁻²⁴. The split the SSD backward kernels apply to
    their tensor-core operands."""
    out, rest = [], a.float()
    for _ in range(parts):
        out.append(rest.to(torch.bfloat16).float())
        rest = rest - out[-1]
    return tuple(out)


def _split_product(eq: str, a: torch.Tensor, b: torch.Tensor, split: Optional[torch.dtype],
                   f32: Optional[int]) -> torch.Tensor:
    """``einsum(eq, a, b)`` with the operands the kernels of dtype ``split``
    give their bf16 products. For bf16, operand ``f32`` (0, 1 or None) in two
    parts and a raw input as it is; for f32, both in three parts. The sum of
    the products of parts i and j with i + j below the larger count, largest
    first. None: the plain f32 product."""
    if split is None:
        return torch.einsum(eq, a, b)
    raw, f32_parts = (3, 3) if split == torch.float32 else (1, 2)

    def parts(t: torch.Tensor, is_f32: bool) -> Tuple[torch.Tensor, ...]:
        n = f32_parts if is_f32 else raw
        return split_bf16(t, n) if n > 1 else (t,)
    pa, pb = parts(a, f32 == 0), parts(b, f32 == 1)
    out = None
    for t in range(max(len(pa), len(pb))):
        for i in range(min(t + 1, len(pa))):
            if t - i < len(pb):
                term = torch.einsum(eq, pa[i], pb[t - i])
                out = term if out is None else out + term
    return out


def ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bmat: torch.Tensor,
                 Cmat: torch.Tensor, h0: Optional[torch.Tensor], dy: torch.Tensor,
                 dh_final: Optional[torch.Tensor], *, chunk: int,
                 split: Optional[torch.dtype] = None) -> Tuple[torch.Tensor, ...]:
    """The gradient of the chunked SSD (``ssd_scan``) as explicit formulas, in
    f32, in the phase order of the backward kernels: x (B,S,H,P), dt (B,S,H),
    A (H,), Bmat and Cmat (B,S,N), h0 (B,H,P,N) or None, dy (B,S,H,P) and
    dh_final (B,H,P,N) or None (no gradient on the final state) → (dx in x's
    dtype, ddt f32, dA f32, dB and dC in Bmat's dtype, dh0 f32 or None when h0
    is None).

    Per (row, head) and chunk c, with cum the in-chunk prefix sum of dt·A[h],
    xdt_k = dt_k x_k, S = C·Bᵀ, L_qk = exp(cum_q − cum_k) for k ≤ q (else 0),
    h_c the state entering chunk c and g_c the gradient of h_c:
    1. the reverse state pass, g_nc = dh_final, g_c = exp(cum_end) g_{c+1}
       + Σ_q exp(cum_q) dy_q ⊗ C_q, and dh0 = g_0;
    2. per chunk, G = dY·XDTᵀ, dxdt = (L∘S)ᵀ dY + exp(cum_end − cum_k)
       g_{c+1} B_k, dx = dt·dxdt and ddt ⊇ Σ_p x·dxdt;
    3. dB and dC, sums over the heads that share the one B/C group: with
       M = Σ_h L∘G, dC = M B + Σ_h exp(cum_q) dy_qᵀ h_c and dB = Mᵀ C
       + Σ_h exp(cum_end − cum_k) xdt_kᵀ g_{c+1};
    4. dcum = the row sums minus the column sums of L∘S∘G, plus the carried
       term exp(cum_q) dy_q·(h_c C_q), minus the state term u_k =
       exp(cum_end − cum_k) xdt_k·(g_{c+1} B_k); Σ_k u_k and exp(cum_end)
       ⟨g_{c+1}, h_c⟩ go to cum_end. The reverse cumsum inside the chunk
       gives d(dA), so ddt += A·d(dA) and dA[h] = Σ d(dA)·dt.
    Steps past S are padded with dt = 0, as the forward pads them.

    ``split`` (tests only) mirrors the operand rounding of the CUDA kernels
    of that dtype in G, (L∘S)ᵀ dY, g_{c+1} B_k, dy_qᵀ h_c and x_kᵀ g_{c+1}
    (``_split_product``): for bf16, each f32 operand as bf16 hi + lo and the
    raw inputs as they are; for f32, every operand in three bf16 parts; dt_k
    and the decay weights applied to the products' results."""
    global calls
    calls += 1
    Bb, S, H, P = x.shape
    N = Bmat.shape[-1]
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        x, dy = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, dy))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bmat, Cmat = (F.pad(t, (0, 0, 0, pad)) for t in (Bmat, Cmat))
    nc = (S + pad) // Q
    xf = x.float().reshape(Bb, nc, Q, H, P)
    dyf = dy.float().reshape(Bb, nc, Q, H, P)
    dtf = dt.float().reshape(Bb, nc, Q, H)
    Bf = Bmat.float().reshape(Bb, nc, Q, N)
    Cf = Cmat.float().reshape(Bb, nc, Q, N)
    Af = A.float()
    xdt = xf * dtf[..., None]
    cs = (dtf * Af).cumsum(2)                              # cum, (B, nc, Q, H)
    csh = cs.transpose(2, 3)                               # (B, nc, H, Q)
    tri = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    L = torch.exp((csh[..., :, None] - csh[..., None, :]).masked_fill(~tri, float("-inf")))
    scores = torch.einsum("bcqn,bckn->bcqk", Cf, Bf)       # S, (B, nc, Q, Q)
    dec_end = torch.exp(cs[:, :, -1:] - cs)                # (B, nc, Q, H)
    chunk_decay = torch.exp(cs[:, :, -1])                  # (B, nc, H)

    # the forward's entering states h_c
    s_chunk = torch.einsum("bcqn,bcqhp->bchpn", Bf, xdt * dec_end[..., None])
    h = (h0.float() if h0 is not None
         else torch.zeros((Bb, H, P, N), dtype=torch.float32, device=x.device))
    h_enter = []
    for c in range(nc):
        h_enter.append(h)
        h = chunk_decay[:, c, :, None, None] * h + s_chunk[:, c]
    h_enter = torch.stack(h_enter, 1)                      # (B, nc, H, P, N)

    # 1. reverse state pass: g_after[c] = g_{c+1}, the gradient leaving chunk c
    d_chunk = torch.einsum("bcqhp,bcqn->bchpn", dyf * torch.exp(cs)[..., None], Cf)
    g = (dh_final.float() if dh_final is not None
         else torch.zeros((Bb, H, P, N), dtype=torch.float32, device=x.device))
    g_after = [None] * nc
    for c in reversed(range(nc)):
        g_after[c] = g
        g = chunk_decay[:, c, :, None, None] * g + d_chunk[:, c]
    dh0 = g if h0 is not None else None
    g_after = torch.stack(g_after, 1)                      # (B, nc, H, P, N)

    # 2. per chunk: G, dxdt, dx and the x part of ddt
    if split is None:
        G = torch.einsum("bcqhp,bckhp->bchqk", dyf, xdt)   # (B, nc, H, Q, Q)
    else:  # dy_q·x_k, then dt_k
        G = (_split_product("bcqhp,bckhp->bchqk", dyf, xf, split, None)
             * dtf.transpose(2, 3)[:, :, :, None, :])
    LS = L * scores[:, :, None]
    gB = _split_product("bchpn,bckn->bckhp", g_after, Bf, split, 0)  # g_{c+1} B_k
    dxdt = (_split_product("bchqk,bcqhp->bckhp", LS, dyf, split, 0)
            + dec_end[..., None] * gB)
    dx = dxdt * dtf[..., None]
    ddt = (xf * dxdt).sum(-1)                              # (B, nc, Q, H)

    # 3. dB and dC, summed over the heads
    LG = L * G
    M = LG.sum(2)                                          # (B, nc, Q, Q)
    dyh = _split_product("bcqhp,bchpn->bcqhn", dyf, h_enter, split, 1)  # dy_qᵀ h_c per head
    if split is None:
        xg = torch.einsum("bckhp,bchpn->bckhn", xdt, g_after)  # xdt_kᵀ g_{c+1} per head
    else:  # x_kᵀ g_{c+1}, then dt_k
        xg = _split_product("bckhp,bchpn->bckhn", xf, g_after, split, 1) * dtf[..., None]
    dC = (torch.einsum("bcqk,bckn->bcqn", M, Bf)
          + torch.einsum("bcqh,bcqhn->bcqn", torch.exp(cs), dyh))
    dB = (torch.einsum("bcqk,bcqn->bckn", M, Cf)
          + torch.einsum("bckh,bckhn->bckn", dec_end, xg))

    # 4. dcum, its reverse cumsum d(dA), then ddt and dA
    T = LG * scores[:, :, None]
    carried = torch.exp(cs) * torch.einsum("bcqhn,bcqn->bcqh", dyh, Cf)
    u = dec_end * torch.einsum("bckhn,bckn->bckh", xg, Bf)
    dcum = (T.sum(-1) - T.sum(-2)).transpose(2, 3) + carried - u   # (B, nc, Q, H)
    end = u.sum(2) + chunk_decay * (g_after * h_enter).sum((-1, -2))  # (B, nc, H)
    dda = dcum.flip(2).cumsum(2).flip(2) + end[:, :, None]
    ddt = ddt + Af * dda
    dA = (dda * dtf).sum((0, 1, 2))

    def unchunk(t, dtype):
        return t.reshape(Bb, nc * Q, *t.shape[3:])[:, :S].to(dtype)
    return (unchunk(dx, x.dtype), unchunk(ddt, torch.float32), dA,
            unchunk(dB, Bmat.dtype), unchunk(dC, Cmat.dtype), dh0)


def ssd_sequential(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bmat: torch.Tensor, Cmat: torch.Tensor,
                   h0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD oracle, one step at a time in f32: h_t = exp(A dt_t) h_{t-1} +
    dt_t x_t ⊗ B_t, y_t = h_t · C_t. Returns (y in x's dtype, final state f32)."""
    global calls
    calls += 1
    Bb, S, H, P = x.shape
    xf, dtf, Bf, Cf, Af = x.float(), dt.float(), Bmat.float(), Cmat.float(), A.float()
    h = (h0.float() if h0 is not None
         else torch.zeros((Bb, H, P, Bmat.shape[-1]), dtype=torch.float32, device=x.device))
    ys = []
    for t in range(S):
        decay = torch.exp(Af * dtf[:, t])                  # (B, H)
        update = (dtf[:, t, :, None, None] * xf[:, t, :, :, None]) * Bf[:, t, None, None, :]
        h = decay[..., None, None] * h + update
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cf[:, t]))
    return torch.stack(ys, 1).to(x.dtype), h


def rglru_scan(x: torch.Tensor, a_log: torch.Tensor, *,
               h0: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RG-LRU recurrence h_t = a_t h_{t-1} + sqrt(max(1 - a_t², 1e-12)) x_t with
    a = exp(a_log), sequential in f32. x, a_log (B,S,W), h0 (B,W) or None →
    (y (B,S,W), h_last (B,W)), both in x's dtype."""
    global calls
    calls += 1
    a = torch.exp(a_log.float())
    g = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * x.float()
    h = (h0.float() if h0 is not None
         else torch.zeros((x.shape[0], x.shape[2]), dtype=torch.float32, device=x.device))
    ys = []
    for t in range(x.shape[1]):
        h = a[:, t] * h + g[:, t]
        ys.append(h)
    return torch.stack(ys, 1).to(x.dtype), h.to(x.dtype)


def rglru_scan_bwd(x: torch.Tensor, a_log: torch.Tensor, h0: Optional[torch.Tensor],
                   dy: Optional[torch.Tensor], dh_last: Optional[torch.Tensor]
                   ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """The gradient of ``rglru_scan`` as its closed form, in f32, with the
    backward kernel's signature: x, a_log (B,S,W), h0 (B,W) or None, dy
    (B,S,W) or None and dh_last (B,W) or None (no gradient on the outputs or
    on the final state) → (dx in x's dtype, da_log f32, dh0 f32 or None when
    h0 is None).

    With a_t = exp(a_log_t), s_t = √max(1 − a_t², 1e-12), h_{t−1} the f32
    state entering step t (h0 or 0 first) and g_t = dy_t + a_{t+1} g_{t+1}
    in reverse time, dh_last added to g's last row:
    dx_t = s_t g_t, da_log_t = a_t g_t (h_{t−1} − a_t x_t / s_t), the √ term
    dropped where 1 − a_t² < 1e-12 (the clamp's constant side), and dh0 =
    a_0 g_0."""
    global calls
    calls += 1
    B, S, W = x.shape
    a = torch.exp(a_log.float())
    u = 1.0 - a * a
    s = torch.sqrt(torch.clamp_min(u, 1e-12))
    xf = x.float()
    zeros = torch.zeros((B, W), dtype=torch.float32, device=x.device)
    h = h0.float() if h0 is not None else zeros
    h_prev = []
    for t in range(S):
        h_prev.append(h)
        h = a[:, t] * h + s[:, t] * xf[:, t]
    h_prev = torch.stack(h_prev, 1)
    dyf = dy.float() if dy is not None else torch.zeros_like(xf)
    carry = dh_last.float() if dh_last is not None else zeros
    g = [None] * S
    for t in reversed(range(S)):
        g[t] = dyf[:, t] + carry
        carry = a[:, t] * g[t]
    g = torch.stack(g, 1)
    ds_da = torch.where(u >= 1e-12, -a / s, torch.zeros_like(a))
    da_log = a * g * (h_prev + ds_da * xf)
    return (s * g).to(x.dtype), da_log, carry if h0 is not None else None


def burst_gather(arena: torch.Tensor, slots: torch.Tensor, lengths: torch.Tensor,
                 out_width: int) -> torch.Tensor:
    """Gather packets ``arena[slots]`` (n_slots, slot_size) uint8 into an
    (n, out_width) uint8 batch: bytes at or past each length are 0, and rows
    narrower than ``out_width`` are zero-padded. Slots index as JAX does: a
    negative slot has n_slots added once, then every slot is clamped to
    [0, n_slots - 1]."""
    global calls
    calls += 1
    n_slots, slot_size = arena.shape
    if slots.numel() and n_slots == 0:
        raise ValueError(f"burst_gather: {slots.numel()} descriptors into an arena "
                         "with no slots")
    s = slots.long()
    s = torch.where(s < 0, s + n_slots, s).clamp(0, max(n_slots - 1, 0))
    rows = arena[s]
    rows = rows[:, :out_width] if slot_size >= out_width else F.pad(
        rows, (0, out_width - slot_size))
    col = torch.arange(out_width, device=arena.device)[None, :]
    return torch.where(col < lengths.long()[:, None], rows, 0).to(torch.uint8)


def epoch_pass(handed: torch.Tensor, ser: torch.Tensor, busy0: int, latency: int,
               table: Optional[torch.Tensor] = None, fids: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, int, Optional[torch.Tensor]]:
    """The epoch pass (``epoch_pass_np``) in torch: handed, ser (n,) int64,
    handed non-decreasing → (arrivals (n,), busy_until int, queues or None).
    end_i = max(busy0, cummax_{j<=i}(t_j - S_{j-1})) + S_i with S the cumsum of
    ser, arrivals = end + latency, busy_until = end_{n-1} (busy0 when n = 0),
    and queues = table[fids] where both are given, indexed as numpy indexes
    (a negative id counts from the end; one outside [-n_flows, n_flows)
    raises IndexError)."""
    global calls
    calls += 1
    queues = table[fids] if table is not None and fids is not None else None
    if handed.shape[0] == 0:
        return handed.new_empty(0), int(busy0), queues
    cum = torch.cumsum(ser, 0)
    pre = handed - (cum - ser)
    ends = torch.cummax(pre, 0).values.clamp_min(busy0) + cum
    return ends + latency, int(ends[-1]), queues
