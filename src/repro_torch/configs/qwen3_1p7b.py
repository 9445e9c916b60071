"""qwen3-1.7b [dense] 28L d2048 16H GQA-8 ff6144 v151936 (qk_norm) — the
assigned config and its reduced smoke config (copies of the reference's)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    parallel_layout='fsdp',
    arch_id='qwen3-1.7b',
    family='dense',
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=6144,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1000000.0,
    tie_embeddings=True,)

SMOKE_CONFIG = ModelConfig(
    arch_id='qwen3-1.7b',
    family='dense',
    qk_norm=True,
    tie_embeddings=True,
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=512,)
