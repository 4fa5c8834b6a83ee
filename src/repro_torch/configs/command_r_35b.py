"""Command-R 35B [hf:CohereForAI/c4ai-command-r-v01]: 40L, d_model 8192,
64H (GQA kv=8... v01 uses MHA-like 64/64; assignment says kv=8), d_ff 22528,
no biases, 256k vocab."""
from repro_torch.config import ArchConfig

ARCH = ArchConfig(
    name="command-r-35b", family="dense",
    n_layers=40, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22528, vocab_size=256000, head_dim=128,
    rope_theta=8e6, mlp_act="silu", mlp_gated=True,
    norm="layernorm", tie_embeddings=True,
)
