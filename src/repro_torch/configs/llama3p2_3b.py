"""llama3.2-3b [dense] 28L d3072 24H GQA-8 ff8192 v128256 [hf:meta-
llama/Llama-3.2-1B] — the assigned config and its reduced smoke config
(copies of the reference's)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    parallel_layout='fsdp',
    arch_id='llama3.2-3b',
    family='dense',
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    rope_theta=500000.0,
    tie_embeddings=True,)

SMOKE_CONFIG = ModelConfig(
    arch_id='llama3.2-3b',
    family='dense',
    tie_embeddings=True,
    n_layers=4,
    d_model=60,
    n_heads=6,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=512,)
