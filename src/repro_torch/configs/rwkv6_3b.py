"""rwkv6-3b [ssm] — Finch, 32L d_model=2560 (attn-free, 40 heads × 64)
d_ff=8960 vocab=65536, data-dependent decay [arXiv:2404.05892; hf].
O(1)-state decode ⇒ runs the long_500k cell."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm",
    num_layers=32, d_model=2560, num_heads=40, num_kv_heads=40, head_dim=64,
    d_ff=8960, vocab_size=65536,
    rwkv=True, pos="none", norm="layernorm",
    supports_long_context=True,
)
