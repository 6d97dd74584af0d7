"""phi3.5-moe-42b-a6.6b [moe] — 16 experts top-2, GQA kv=8
[hf:microsoft/Phi-3.5-MoE-instruct]."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    arch_type="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,
    vocab_size=32064,
    n_experts=16,
    moe_top_k=2,
    source="hf:microsoft/Phi-3.5-MoE-instruct",
)


def smoke():
    return FULL.with_(n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
                      d_ff=256, vocab_size=512, n_experts=4, moe_top_k=2, capacity_factor=4.0,
                      remat=False)
