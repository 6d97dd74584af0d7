"""whisper-medium [audio] — enc-dec, conv/mel frontend STUBBED
[arXiv:2212.04356]. 24 encoder + 24 decoder layers, d_model=1024."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="whisper-medium",
    arch_type="audio",
    n_layers=24,              # decoder layers
    n_enc_layers=24,
    enc_seq=1500,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    source="arXiv:2212.04356",
)


def smoke():
    return FULL.with_(n_layers=2, n_enc_layers=2, enc_seq=64, d_model=128,
                      n_heads=4, n_kv_heads=4, d_ff=256, vocab_size=512,
                      remat=False)
