"""internvl2-26b [vlm] — InternViT (STUBBED) + InternLM2-20B-class backbone
[arXiv:2404.16821]. Inputs are precomputed patch embeddings."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="internvl2-26b",
    arch_type="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    n_patches=1024,
    source="arXiv:2404.16821",
)


def smoke():
    return FULL.with_(n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
                      d_ff=512, vocab_size=512, n_patches=16, remat=False)
