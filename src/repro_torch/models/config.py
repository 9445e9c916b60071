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
    def has_decode(self) -> bool:
        return self.causal  # encoder-only archs have no autoregressive decode

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Parameters of a dense, hybrid or ssm config (the families this port
        serves), counted as the JAX package counts them."""
        D, F, V = self.d_model, self.d_ff, self.vocab_size
        total = V * D + (0 if self.tie_embeddings else V * D) + D
        attn = (D * self.q_dim + 2 * D * self.kv_dim + self.q_dim * D
                + (2 * self.head_dim if self.qk_norm else 0) + 2 * D)
        mlp = 3 * D * F if self.act == "silu" else 2 * D * F
        if self.family == "dense":
            return total + self.n_layers * (attn + mlp)
        if self.family == "ssm":
            # in_proj (D -> 2*d_inner + 2*N + H), conv, A/dt_bias/D, norm, out_proj
            d_in, H, N = self.d_inner, self.n_ssm_heads, self.ssm_state
            in_proj = D * (2 * d_in + 2 * N + H)
            conv = self.conv_width * (d_in + 2 * N)
            return total + self.n_layers * (in_proj + conv + 2 * H + d_in + d_in * D + D)
        if self.family == "hybrid":
            W = self.lru_width
            rglru = (D * W * 2 + self.conv_width * W + 2 * W * W // 8 + W * D
                     + 2 * W + 2 * D)
            pat = self.block_pattern
            n_rec = sum(1 for i in range(self.n_layers) if pat[i % len(pat)] == "rglru")
            n_att = self.n_layers - n_rec
            return total + n_rec * (rglru + mlp + D) + n_att * (attn + mlp + D)
        raise NotImplementedError(
            f"param_count covers the dense, hybrid and ssm families, not {self.family!r}")
