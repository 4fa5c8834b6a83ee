"""DeepSeek-V3 671B [arXiv:2412.19437]: MLA, 1 shared + 256 routed top-8
experts, MTP. 61 layers (first 3 dense, d_ff 18432), d_model 7168,
128 attention heads, expert FFN 2048, vocab 129280."""
from repro_torch.config import ArchConfig, MLAConfig, MoEConfig

ARCH = ArchConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
    d_ff=18432, vocab_size=129280,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64,
                  v_head_dim=128),
    moe=MoEConfig(n_experts=256, top_k=8, d_expert=2048,
                  n_shared_experts=1, d_shared=2048,
                  router_softmax=False),  # V3 uses sigmoid routing
    n_dense_layers=3, mtp_depth=1,
    rope_theta=10000.0, mlp_act="silu", mlp_gated=True,
)
