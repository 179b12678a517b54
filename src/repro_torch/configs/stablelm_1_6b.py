"""stablelm-1.6b [dense] — 24L d_model=2048 32H (GQA kv=32, i.e. MHA)
d_ff=5632 vocab=100352  [hf:stabilityai/stablelm-2-1_6b; unverified].
StableLM-2 flavour: LayerNorm, partial rotary 25%, SwiGLU."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b", family="dense",
    num_layers=24, d_model=2048, num_heads=32, num_kv_heads=32, head_dim=64,
    d_ff=5632, vocab_size=100352,
    norm="layernorm", partial_rotary=0.25, act="silu", mlp_gated=True,
    use_bias=False, pos="rope", rope_theta=10000.0,
)
