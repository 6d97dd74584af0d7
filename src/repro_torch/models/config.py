"""Model/architecture configuration: the port's own copy of the JAX
package's ``models/config.py``, field for field, so one config means the
same model in both packages.

One frozen dataclass covers all six assigned arch families; family-specific
fields default to 0/None and are validated by the registry. The port
builds the token families so far (``models/registry.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                    # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    vocab_size: int
    # attention (0 heads => attention-free)
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0                 # 0 => d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None   # None => full causal attention
    flash_decode: bool = False        # shard_map partial-softmax decode over
                                      # the seq-sharded KV cache (§Perf #2)
    # mlp
    d_ff: int = 0
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0                 # expert hidden (deepseek-style); 0 => d_ff
    capacity_factor: float = 1.25
    moe_group_size: int = 4096        # dispatch group tokens (perf knob)
    moe_layer_start: int = 0          # first MoE layer index (deepseek: layer 0 dense)
    # MLA (deepseek)
    kv_lora_rank: int = 0             # 0 => regular GQA
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128
    # SSM (mamba)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_dt_rank: int = 0              # 0 => ceil(d_model/16)
    ssm_head_dim: int = 64            # mamba2 only
    ssm_version: int = 1              # 1 | 2
    ssm_chunk: int = 128              # chunked-scan chunk length
    use_pallas: bool = False          # route hot loops through kernels/ (CUDA)
    # hybrid (zamba2)
    attn_every: int = 0               # shared attn block applied every k core layers
    # enc-dec (whisper)
    n_enc_layers: int = 0
    enc_seq: int = 1500               # post-conv audio frames (frontend stubbed)
    # vlm
    n_patches: int = 0                # vision prefix length (encoder stubbed)
    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = True
    scan_unroll: bool = False         # fully unroll layer/seq scans (cost probes)
    # metadata
    source: str = ""                  # citation

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.n_heads:
            return self.d_model // self.n_heads
        return 0

    @property
    def resolved_dt_rank(self) -> int:
        return self.ssm_dt_rank or -(-self.d_model // 16)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def is_attention_free(self) -> bool:
        return self.arch_type == "ssm"

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                         # train | prefill | decode


INPUT_SHAPES = {
    "train_4k":    InputShape("train_4k",    4_096,   256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  InputShape("decode_32k",  32_768,  128, "decode"),
    "long_500k":   InputShape("long_500k",   524_288, 1,   "decode"),
}
