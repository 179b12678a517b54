"""qwen3-8b [dense] — 36L d_model=4096 32H (GQA kv=8) d_ff=12288
vocab=151936, qk_norm [hf:Qwen/Qwen3-8B; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b", family="dense",
    num_layers=36, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=12288, vocab_size=151936,
    norm="rmsnorm", act="silu", mlp_gated=True, use_bias=False,
    qk_norm=True, pos="rope", rope_theta=1000000.0,
)
