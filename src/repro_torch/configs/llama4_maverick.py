"""llama4-maverick-400b-a17b [moe] 48L d5120 40H GQA-8 ff8192 v202048, 128e
top-1 every-2nd layer + shared expert [hf:meta-llama/Llama-4-*] — the
assigned config and its reduced smoke config (copies of the reference's)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id='llama4-maverick-400b-a17b',
    family='moe',
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    n_experts=128,
    experts_per_token=1,
    moe_every=2,
    n_shared_experts=1,
    rope_theta=500000.0,)

SMOKE_CONFIG = ModelConfig(
    arch_id='llama4-maverick-400b-a17b',
    family='moe',
    n_experts=8,
    experts_per_token=1,
    moe_every=2,
    n_shared_experts=1,
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=512,)
