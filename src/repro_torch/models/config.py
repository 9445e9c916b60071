"""Model configuration (own copy of the reference package's ``ModelConfig``).

Field names, defaults and derived properties are the same as in the JAX
package so that configs and parameter counts compare one to one.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                      # dense | moe | hybrid | ssm | encoder | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None   # default: d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-6
    act: str = "silu"                # silu (SwiGLU) | gelu (plain MLP)
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    causal: bool = True              # False for encoder-only
    tie_embeddings: bool = False

    # attention variants
    attention_kind: str = "full"     # full | sliding (SWA) | local (hybrid)
    window: int = 0                  # sliding/local window size

    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    moe_every: int = 1
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # hybrid (RG-LRU / recurrentgemma)
    block_pattern: Tuple[str, ...] = ()
    lru_width: Optional[int] = None

    # ssm (mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_width: int = 4

    # modality frontend
    frontend: str = "none"           # none | audio_frames | vision_patches
    n_patches: int = 256

    # distribution and remat (kept for config parity; one device ignores them)
    parallel_layout: str = "tp"
    remat_policy: str = "full"

    # numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    def __post_init__(self) -> None:
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // max(1, self.n_heads))
        if self.family == "hybrid" and not self.block_pattern:
            object.__setattr__(self, "block_pattern", ("rglru", "rglru", "attn"))
        if self.lru_width is None:
            object.__setattr__(self, "lru_width", self.d_model)

    @property
    def d_inner(self) -> int:  # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def is_subquadratic(self) -> bool:
        """Can this arch run 500k-token contexts? (SSM/hybrid/SWA)"""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.attention_kind == "sliding" and self.window > 0

    @property
    def has_decode(self) -> bool:
        return self.causal  # encoder-only archs have no autoregressive decode

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # -- parameter counting, as the JAX package counts ------------------------
    def param_count(self) -> int:
        return _param_count(self, active_only=False)

    def active_param_count(self) -> int:
        """Parameters one token passes through: an MoE layer counts its
        ``experts_per_token`` routed experts, not all of them."""
        return _param_count(self, active_only=True)


def _param_count(cfg: ModelConfig, active_only: bool) -> int:
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    emb = V * D
    out_head = 0 if cfg.tie_embeddings else V * D
    total = emb + out_head + D  # final norm

    def attn_params() -> int:
        return D * cfg.q_dim + 2 * D * cfg.kv_dim + cfg.q_dim * D + (
            2 * cfg.head_dim if cfg.qk_norm else 0
        ) + 2 * D  # two norms per block

    def mlp_params(f: int) -> int:
        if cfg.act == "silu":
            return 3 * D * f
        return 2 * D * f

    if cfg.family == "ssm":
        # mamba2: in_proj (D -> 2*d_inner + 2*G*N + H), conv, A/D, norm, out_proj
        d_in = cfg.d_inner
        H = cfg.n_ssm_heads
        G = 1  # single B/C group
        in_proj = D * (2 * d_in + 2 * G * cfg.ssm_state + H)
        conv = cfg.conv_width * (d_in + 2 * G * cfg.ssm_state)
        per_layer = in_proj + conv + 2 * H + d_in + d_in * D + D
        total += cfg.n_layers * per_layer
        return total

    if cfg.family == "hybrid":
        W = cfg.lru_width
        # RG-LRU block: in projs (2), conv, gates (2 diag-ish dense), out proj
        rglru = D * W * 2 + cfg.conv_width * W + 2 * W * W // 8 + W * D + 2 * W + 2 * D
        attn = attn_params()
        mlp = mlp_params(F) + D
        n_rec = sum(1 for i in range(cfg.n_layers)
                    if cfg.block_pattern[i % len(cfg.block_pattern)] == "rglru")
        n_att = cfg.n_layers - n_rec
        total += n_rec * (rglru + mlp) + n_att * (attn + mlp)
        return total

    for layer in range(cfg.n_layers):
        total += attn_params()
        is_moe = cfg.n_experts > 0 and (layer % cfg.moe_every == cfg.moe_every - 1)
        if is_moe:
            router = D * cfg.n_experts
            experts = cfg.n_experts if not active_only else cfg.experts_per_token
            total += router + experts * mlp_params(F)
            total += cfg.n_shared_experts * mlp_params(F)
        else:
            total += mlp_params(F)
    return total
