"""internvl2-26b [vlm] 48L d6144 48H GQA-8 ff16384 v92553 (InternViT stub +
InternLM2) [arXiv:2404.16821] — the assigned config and its reduced smoke
config (copies of the reference's)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    parallel_layout='fsdp',
    arch_id='internvl2-26b',
    family='vlm',
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    frontend='vision_patches',
    n_patches=256,
    rope_theta=1000000.0,)

SMOKE_CONFIG = ModelConfig(
    arch_id='internvl2-26b',
    family='vlm',
    frontend='vision_patches',
    n_patches=16,
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=512,)
