"""qwen3-moe-30b-a3b [moe] — 48L d_model=2048 32H (GQA kv=4) expert
d_ff=768 vocab=151936, MoE 128e top-8, norm_topk, qk_norm
[hf:Qwen/Qwen3-30B-A3B; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4, head_dim=128,
    d_ff=768, vocab_size=151936,
    norm="rmsnorm", act="silu", mlp_gated=True, use_bias=False,
    qk_norm=True, pos="rope", rope_theta=1000000.0,
    num_experts=128, top_k=8, moe_d_ff=768, norm_topk=True,
    capacity_factor=1.25,
)
