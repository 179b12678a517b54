"""starcoder2-15b [dense] — 40L d_model=6144 48H (GQA kv=4) d_ff=24576
vocab=49152, RoPE [arXiv:2402.19173; hf]. StarCoder2 flavour: LayerNorm,
non-gated GeLU MLP, biases."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b", family="dense",
    num_layers=40, d_model=6144, num_heads=48, num_kv_heads=4, head_dim=128,
    d_ff=24576, vocab_size=49152,
    norm="layernorm", act="gelu", mlp_gated=False, use_bias=True,
    pos="rope", rope_theta=100000.0, tie_embeddings=True,
)
