"""InternVL2-1B [arXiv:2404.16821]: InternViT-300M frontend (STUB: the
assignment provides precomputed patch embeddings) + Qwen2-0.5B LM backbone:
24L, d_model 896, 14H (GQA kv=2), d_ff 4864, vocab 151655."""
from repro_torch.config import ArchConfig, VisionStubConfig

ARCH = ArchConfig(
    name="internvl2-1b", family="vlm",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
    d_ff=4864, vocab_size=151655, head_dim=64,
    rope_theta=1e6, attn_bias=True,  # Qwen2 uses QKV bias
    mlp_act="silu", mlp_gated=True,
    vision=VisionStubConfig(n_patches=256),
)
