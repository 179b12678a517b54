"""jamba-v0.1-52b [hybrid] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, Mamba+attn 1:7 interleave (attention at layer i%8==4), MoE
16e top-2 every other layer (i%2==1) [arXiv:2403.19887; hf].
Hybrid ⇒ runs the long_500k cell (only 4 of 32 layers carry KV cache)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=65536,
    norm="rmsnorm", act="silu", mlp_gated=True, use_bias=False, pos="none",
    num_experts=16, top_k=2, moe_d_ff=14336, moe_every=2, moe_offset=1,
    attn_every=8, attn_offset=4, d_state=16, d_conv=4, expand=2,
    capacity_factor=1.25, supports_long_context=True,
)
