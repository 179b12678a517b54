"""internvl2-2b [vlm] — InternViT frontend STUB + InternLM2-1.8B backbone:
24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553
[arXiv:2404.16821; hf]. input_specs provides precomputed patch embeddings."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b", family="vlm",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=92553,
    norm="rmsnorm", act="silu", mlp_gated=True, use_bias=False,
    pos="rope", rope_theta=1000000.0,
    num_prefix_embeds=256,
)
