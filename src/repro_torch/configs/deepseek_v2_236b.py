"""deepseek-v2-236b [moe] — MLA kv_lora=512, 2 shared + 160 routed top-6
[arXiv:2405.04434]. Layer 0 is dense (moe_layer_start=1)."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="deepseek-v2-236b",
    arch_type="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_ff=12288,              # dense-layer / shared-path ffn
    vocab_size=102400,
    n_experts=160,
    n_shared_experts=2,
    moe_top_k=6,
    moe_d_ff=1536,
    moe_layer_start=1,
    kv_lora_rank=512,
    qk_rope_dim=64,
    qk_nope_dim=128,
    v_head_dim=128,
    source="arXiv:2405.04434",
)


def smoke():
    return FULL.with_(n_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
                      d_ff=512, vocab_size=512, n_experts=4, moe_top_k=2, capacity_factor=4.0,
                      n_shared_experts=1, moe_d_ff=128, moe_layer_start=1,
                      kv_lora_rank=64, qk_rope_dim=16, qk_nope_dim=32,
                      v_head_dim=32, remat=False)
