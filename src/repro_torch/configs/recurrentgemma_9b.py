"""recurrentgemma-9b [hybrid] 38L d4096 16H MQA ff12288 v256000, RG-LRU +
local attention 1:2 — the assigned config and its reduced smoke config
(copies of the reference's)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    parallel_layout='fsdp',
    arch_id='recurrentgemma-9b',
    family='hybrid',
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    attention_kind='local',
    window=2048,
    block_pattern=('rglru', 'rglru', 'attn'),
    rope_theta=10000.0,
    tie_embeddings=True,)

SMOKE_CONFIG = ModelConfig(
    arch_id='recurrentgemma-9b',
    family='hybrid',
    attention_kind='local',
    window=16,
    block_pattern=('rglru', 'rglru', 'attn'),
    tie_embeddings=True,
    n_layers=5,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    d_ff=128,
    vocab_size=512,)
