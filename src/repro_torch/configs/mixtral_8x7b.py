"""mixtral-8x7b [moe] 32L d4096 32H GQA-8 ff14336 v32000, 8e top-2, SWA-4096
[arXiv:2401.04088] — the assigned config and its reduced smoke config
(copies of the reference's)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id='mixtral-8x7b',
    family='moe',
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    n_experts=8,
    experts_per_token=2,
    moe_every=1,
    attention_kind='sliding',
    window=4096,
    rope_theta=1000000.0,)

SMOKE_CONFIG = ModelConfig(
    arch_id='mixtral-8x7b',
    family='moe',
    n_experts=4,
    experts_per_token=2,
    moe_every=1,
    attention_kind='sliding',
    window=32,
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=512,)
