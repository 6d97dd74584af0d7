"""Attention: grouped-query attention (optionally with a sliding window)
and DeepSeek-V2's multi-head latent attention (MLA), the port of the JAX
package's ``models/attention.py``.

Three entry points per variant:
  *_train   — full-sequence causal attention (teacher forcing)
  *_prefill — full sequence, returns the cache for decoding
  *_decode  — one new token per row against an existing cache

Caches:
  GQA: {"k", "v": (B, S_max, H_kv, hd)}, keys stored already roped
  MLA: {"c_kv": (B, S_max, r), "k_rope": (B, S_max, rope_dim)}, the
       compressed latent and the shared roped key
With a sliding window S_max is the window and writes wrap around it.

Long sequences use query-chunked attention (``_CHUNK`` query rows at a
time) so the S×S logits never materialise above that many rows. With
``cfg.flash_decode``, under an entered ``ShardCtx`` whose ``tp`` axis
divides the cache's sequence, ``gqa_decode`` takes the reference's flash
decode (``_gqa_decode_flash``): each model rank attends over its own
contiguous slab of the cache and the ranks exchange only softmax
statistics and the context, never cache bytes. Attention, RoPE and the MLP
sit outside any TPU kernel in the reference, so they are plain PyTorch
here too. The encoder-decoder family adds bidirectional (encoder)
self-attention over GQA weights and cross-attention over the encoder's
precomputed keys and values; both are unmasked and unchunked, as the
reference's are. Queries, keys and values are placed with
``sharding.shard`` where the reference places them (heads on the ``tp``
axis; a no-op without an entered ``ShardCtx``).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.models.layers import apply_rope, dense_init
from repro_torch.sharding.specs import (DTensor, _distribute, _redistribute, _size,
                                        current_ctx, local_heads, merge_heads, placements,
                                        relax, shard, split_heads)

_CHUNK = 1024          # query-chunk rows for long-sequence attention
_NEG = -1e30


def gqa_init(generator: torch.Generator, cfg, dtype=torch.float32, device="cpu"):
    hd = cfg.resolved_head_dim
    p = {
        "wq": dense_init(generator, cfg.d_model, cfg.n_heads * hd, dtype, device=device),
        "wk": dense_init(generator, cfg.d_model, cfg.n_kv_heads * hd, dtype, device=device),
        "wv": dense_init(generator, cfg.d_model, cfg.n_kv_heads * hd, dtype, device=device),
        "wo": dense_init(generator, cfg.n_heads * hd, cfg.d_model, dtype, device=device),
    }
    if cfg.qkv_bias:
        p["b_q"] = torch.zeros((cfg.n_heads * hd,), dtype=dtype, device=device)
        p["b_k"] = torch.zeros((cfg.n_kv_heads * hd,), dtype=dtype, device=device)
        p["b_v"] = torch.zeros((cfg.n_kv_heads * hd,), dtype=dtype, device=device)
    return p


def _qkv(params, x, cfg, positions):
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    dt = x.dtype
    q = x @ params["wq"].to(dt)
    k = x @ params["wk"].to(dt)
    v = x @ params["wv"].to(dt)
    if cfg.qkv_bias:
        q = q + params["b_q"].to(dt)
        k = k + params["b_k"].to(dt)
        v = v + params["b_v"].to(dt)
    q = split_heads(q, cfg.n_heads, hd)
    k = split_heads(k, cfg.n_kv_heads, hd)
    v = split_heads(v, cfg.n_kv_heads, hd)
    q = shard(apply_rope(q, positions, cfg.rope_theta), "batch", None, "tp", None)
    k = shard(apply_rope(k, positions, cfg.rope_theta), "batch", None, "tp", None)
    return q, k, shard(v, "batch", None, "tp", None)


def _repeat_kv(k, n_heads: int):
    """(B,S,H_kv,hd) -> (B,S,H,hd) by group broadcast."""
    B, S, Hkv, hd = k.shape
    rep = n_heads // Hkv
    if rep == 1:
        return k
    return k[:, :, :, None, :].expand(B, S, Hkv, rep, hd).reshape(B, S, n_heads, hd)


def _scale(hd: int) -> float:
    """1/sqrt(hd) rounded to fp32, as the reference computes it."""
    return float(np.float32(1.0) / np.sqrt(np.float32(hd)))


def _attend_rows(q_rows, k, v, mask_rows, scale):
    """q_rows: (B,R,H,hd); k,v: (B,S,H,hd); mask_rows: (R,S) or (B,R,S)."""
    logits = torch.einsum("brhd,bshd->bhrs", q_rows, k).to(torch.float32) * scale
    mask = mask_rows[None, None] if mask_rows.dim() == 2 else mask_rows[:, None]
    logits = torch.where(mask, logits, _NEG)
    probs = torch.softmax(logits, dim=-1).to(q_rows.dtype)
    return torch.einsum("bhrs,bshd->brhd", probs, v)


def causal_attention(q, k, v, cfg, q_offset: int = 0):
    """Chunked causal (optionally sliding-window) attention.

    q: (B,Sq,H,hd); k,v: (B,Sk,H_kv,hd). ``q_offset`` is the absolute
    position of q[0] relative to k[0] (prefill: 0)."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    (q, k, v), wrap = local_heads(q, _repeat_kv(k, H), _repeat_kv(v, H))
    scale = _scale(hd)
    kpos = torch.arange(Sk, device=q.device)

    def mask_for(qpos):
        m = kpos[None, :] <= qpos[:, None]
        if cfg.sliding_window:
            m = m & (kpos[None, :] > (qpos[:, None] - cfg.sliding_window))
        return m

    if Sq <= _CHUNK:
        qpos = torch.arange(Sq, device=q.device) + q_offset
        return wrap(_attend_rows(q, k, v, mask_for(qpos), scale))
    outs = []
    for start in range(0, Sq, _CHUNK):
        qpos = torch.arange(start, min(start + _CHUNK, Sq), device=q.device) + q_offset
        outs.append(_attend_rows(q[:, start:start + _CHUNK], k, v, mask_for(qpos), scale))
    return wrap(torch.cat(outs, dim=1))


def _positions(B: int, S: int, device):
    return torch.arange(S, device=device).expand(B, S)


def row_positions(pos, B: int, device) -> torch.Tensor:
    """A decode's position as one int32 per row (B,): a tensor (one
    position, or one per row) is broadcast; a host int is filled on the
    device, with no host-to-device copy."""
    if isinstance(pos, torch.Tensor):
        return pos.to(device).expand(B)
    return torch.full((B,), int(pos), dtype=torch.int32, device=device)


def _ring(pos, S_max: int, cfg):
    """Where each row's new entry goes and how much of the cache it reads:
    (entry indices (S_max,), the one-hot write mask (B, S_max), valid_len
    (B,)). With a sliding window the slot is ``pos`` modulo the cache;
    without, a position past the cache lands on its last entry, where the
    reference's ``dynamic_update_slice`` clamps it."""
    if cfg.sliding_window:
        slot = pos % S_max
        valid_len = torch.clamp(pos + 1, max=S_max)
    else:
        slot = torch.clamp(pos, max=S_max - 1)
        valid_len = pos + 1
    idx = torch.arange(S_max, device=pos.device)
    return idx, idx[None, :] == slot[:, None], valid_len


def gqa_train(params, x, cfg, positions=None):
    B, S, _ = x.shape
    if positions is None:
        positions = _positions(B, S, x.device)
    q, k, v = _qkv(params, x, cfg, positions)
    return merge_heads(causal_attention(q, k, v, cfg)) @ params["wo"].to(x.dtype)


def gqa_prefill(params, x, cfg, positions=None):
    """Returns (out, cache); the cache holds roped keys at absolute
    positions (the last ``sliding_window`` of them with a window)."""
    B, S, _ = x.shape
    if positions is None:
        positions = _positions(B, S, x.device)
    q, k, v = _qkv(params, x, cfg, positions)
    out = merge_heads(causal_attention(q, k, v, cfg)) @ params["wo"].to(x.dtype)
    if cfg.sliding_window and S > cfg.sliding_window:
        k = k[:, -cfg.sliding_window:]
        v = v[:, -cfg.sliding_window:]
    return out, {"k": k, "v": v}


def gqa_decode(params, x, cache, pos, cfg):
    """One token per row. x: (B,1,d); cache k/v: (B,S_max,H_kv,hd); pos:
    the number of tokens already in context (the new token's absolute
    position), a scalar or one per row (B,).

    Row b writes its k/v at ``pos[b]`` (modulo the window when
    ``sliding_window`` is set; a position past the cache lands on its last
    entry, where the reference's ``dynamic_update_slice`` clamps it) and
    attends to its first ``valid_len[b]`` entries. The write is a one-hot
    ``where``, so the cache passed in is not modified. With
    ``cfg.flash_decode`` under the reference's condition (an entered
    ``ShardCtx`` whose logical map has ``tp``, an axis size that divides
    the cache's sequence) the step is ``_gqa_decode_flash``."""
    if cfg.flash_decode:
        ctx = current_ctx()
        tp = ctx.logical_map.get("tp") if ctx is not None and ctx.mesh is not None else None
        if tp and cache["k"].shape[1] % _size(ctx.mesh, tp) == 0:
            return _gqa_decode_flash(params, x, cache, pos, cfg)
    B = x.shape[0]
    dt = x.dtype
    S_max = cache["k"].shape[1]
    pos = row_positions(pos, B, x.device)
    q, k_new, v_new = _qkv(params, x, cfg, pos[:, None])
    idx, write, valid_len = _ring(pos, S_max, cfg)
    write = write[:, :, None, None]                                    # (B,S_max,1,1)
    k = torch.where(write, k_new.to(cache["k"].dtype), cache["k"])
    v = torch.where(write, v_new.to(cache["v"].dtype), cache["v"])

    mask = (idx[None, :] < valid_len[:, None])[:, None, None, :]      # (B,1,1,S_max)
    (q, kk, vv, mask), wrap = local_heads(q, _repeat_kv(k.to(dt), cfg.n_heads),
                                          _repeat_kv(v.to(dt), cfg.n_heads), rows=(mask,))
    logits = torch.einsum("bqhd,bshd->bhqs", q, kk).to(torch.float32) * _scale(q.shape[-1])
    logits = torch.where(mask, logits, _NEG)
    probs = torch.softmax(logits, dim=-1).to(dt)
    out = merge_heads(wrap(torch.einsum("bhqs,bshd->bqhd", probs, vv)))
    return out @ params["wo"].to(dt), {"k": k, "v": v}


# =========================================================== flash decode
def _flash_decode_core(group, n_shards: int, idx: int, windowed: bool, q, k, v, k_new,
                       v_new, pos):
    """One model rank's decode attention over its slab of a
    sequence-sharded cache, on local tensors.

    q, k_new, v_new: (B, 1, H | H_kv, hd), whole on every rank of
    ``group`` (the model axis, ``n_shards`` ranks, this one ``idx``); k, v:
    (B, S_loc, H_kv, hd), the contiguous entries ``[idx·S_loc,
    (idx+1)·S_loc)`` of the cache; pos: (B,) positions. The rank holding a
    row's slot writes k_new/v_new there (modulo the cache when
    ``windowed``; past an unwindowed cache no rank writes, as in the
    reference), masks its logits at global positions and takes its local
    max; the max (MAX), the softmax's normaliser and the (B, 1, H, hd)
    context (SUM) are all-reduced over ``group``: O(B·H·hd) elements, not
    the cache. Returns (out (B, 1, H, hd), k, v)."""
    B, S_loc = k.shape[0], k.shape[1]
    S_max = S_loc * n_shards
    start = idx * S_loc
    slot = pos % S_max if windowed else pos
    valid_len = torch.clamp(pos + 1, max=S_max) if windowed else pos + 1
    idx_loc = torch.arange(S_loc, device=k.device)
    write = (idx_loc[None, :] == (slot - start)[:, None])[:, :, None, None]   # (B,S_loc,1,1)
    k = torch.where(write, k_new.to(k.dtype), k)
    v = torch.where(write, v_new.to(v.dtype), v)

    H, hd = q.shape[2], q.shape[3]
    kk = _repeat_kv(k.to(q.dtype), H)
    vv = _repeat_kv(v.to(q.dtype), H)
    logits = torch.einsum("bqhd,bshd->bhqs", q, kk).to(torch.float32) * _scale(hd)
    mask = ((start + idx_loc)[None, :] < valid_len[:, None])[:, None, None, :]  # (B,1,1,S_loc)
    logits = torch.where(mask, logits, _NEG)

    gmax = torch.amax(logits, dim=-1)                                   # (B,H,1)
    dist.all_reduce(gmax, op=dist.ReduceOp.MAX, group=group)
    p = torch.exp(logits - gmax[..., None]) * mask
    denom = torch.sum(p, dim=-1)                                        # (B,H,1)
    dist.all_reduce(denom, op=dist.ReduceOp.SUM, group=group)
    ctx = torch.einsum("bhqs,bshd->bqhd", p.to(q.dtype), vv)
    dist.all_reduce(ctx, op=dist.ReduceOp.SUM, group=group)
    out = ctx / denom.transpose(1, 2)[..., None].to(q.dtype)
    return out, k, v


def _gqa_decode_flash(params, x, cache, pos, cfg):
    """The reference's flash decode (its ``shard_map`` written out): the
    query, the new key and value and the positions whole over ``tp`` and
    split over the client axes where they divide the batch (the
    reference's ``flat_spec``), the cache in its ``cache_shardings``
    placement (batch likewise, sequence on ``tp``) on the way in and out;
    each rank runs ``_flash_decode_core`` on its local tensors. Plain
    tensors (a cache every rank holds whole) are placed the same way, each
    rank keeping its own part, and the outputs are DTensors."""
    ctx = current_ctx()
    mesh, tp = ctx.mesh, ctx.logical_map["tp"]
    B = x.shape[0]
    dt = x.dtype
    pos = row_positions(pos, B, x.device)
    q, k_new, v_new = _qkv(params, x, cfg, pos[:, None])
    flat = relax(q.shape, ctx.resolve(("batch", None, None, None)), mesh)
    cspec = relax(cache["k"].shape, ctx.resolve(("batch", "tp", None, None)), mesh)

    def local(t, spec):
        if isinstance(t, DTensor):
            return _redistribute(t, mesh, spec).to_local()
        return _distribute(t, mesh, placements(spec, mesh)).to_local()

    out, k, v = _flash_decode_core(
        mesh.get_group(tp), _size(mesh, tp), mesh.get_local_rank(tp), bool(cfg.sliding_window),
        local(q, flat), local(cache["k"], cspec), local(cache["v"], cspec),
        local(k_new, flat), local(v_new, flat), local(pos, flat[:1]))
    wrap = lambda t, spec: DTensor.from_local(t, mesh, placements(spec, mesh), run_check=False)
    out = merge_heads(wrap(out, flat)) @ params["wo"].to(dt)
    return out, {"k": wrap(k, cspec), "v": wrap(v, cspec)}


# =========================================================== MLA (DeepSeek)
def mla_init(generator: torch.Generator, cfg, dtype=torch.float32, device="cpu"):
    """Multi-head latent attention: a rank-r compressed KV plus a decoupled
    RoPE key shared by the heads (q-lora is omitted, as in the
    reference)."""
    H, r = cfg.n_heads, cfg.kv_lora_rank
    qk_n, qk_r, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return {
        "wq": dense_init(generator, cfg.d_model, H * (qk_n + qk_r), dtype, device=device),
        "wkv_a": dense_init(generator, cfg.d_model, r + qk_r, dtype, device=device),
        "wkv_b": dense_init(generator, r, H * (qk_n + dv), dtype, device=device),
        "wo": dense_init(generator, H * dv, cfg.d_model, dtype, device=device),
    }


def _mla_qkv_full(params, x, cfg, positions):
    """The expanded (train and prefill) path: per-head K and V
    materialised from the latent. Returns (q, k, v, c_kv, k_rope)."""
    B, S, _ = x.shape
    H, r = cfg.n_heads, cfg.kv_lora_rank
    qk_n, dv = cfg.qk_nope_dim, cfg.v_head_dim
    dt = x.dtype
    q = (x @ params["wq"].to(dt)).reshape(B, S, H, -1)
    q_nope, q_rope = q[..., :qk_n], apply_rope(q[..., qk_n:], positions, cfg.rope_theta)
    kv_a = x @ params["wkv_a"].to(dt)                                  # (B,S,r+qk_r)
    c_kv = kv_a[..., :r]
    k_rope = apply_rope(kv_a[..., r:][:, :, None, :], positions, cfg.rope_theta)
    kv = (c_kv @ params["wkv_b"].to(dt)).reshape(B, S, H, qk_n + dv)
    k_nope, v = kv[..., :qk_n], kv[..., qk_n:]
    q_full = shard(torch.cat([q_nope, q_rope], dim=-1), "batch", None, "tp", None)
    k_full = torch.cat([k_nope, k_rope.expand(B, S, H, k_rope.shape[-1])], dim=-1)
    k_full = shard(k_full, "batch", None, "tp", None)
    v = shard(v, "batch", None, "tp", None)
    return q_full, k_full, v, c_kv, k_rope[:, :, 0, :]


def mla_train(params, x, cfg, positions=None):
    B, S, _ = x.shape
    if positions is None:
        positions = _positions(B, S, x.device)
    q, k, v, _, _ = _mla_qkv_full(params, x, cfg, positions)
    out = causal_attention(q, k, v, cfg).reshape(B, S, -1)
    return out @ params["wo"].to(x.dtype)


def mla_prefill(params, x, cfg, positions=None):
    """Returns (out, cache); the cache keeps the latent and the roped key
    (the last ``sliding_window`` positions with a window)."""
    B, S, _ = x.shape
    if positions is None:
        positions = _positions(B, S, x.device)
    q, k, v, c_kv, k_rope = _mla_qkv_full(params, x, cfg, positions)
    out = causal_attention(q, k, v, cfg).reshape(B, S, -1) @ params["wo"].to(x.dtype)
    if cfg.sliding_window and S > cfg.sliding_window:
        c_kv = c_kv[:, -cfg.sliding_window:]
        k_rope = k_rope[:, -cfg.sliding_window:]
    return out, {"c_kv": c_kv, "k_rope": k_rope}


def mla_decode(params, x, cache, pos, cfg):
    """Weight-absorbed MLA decode: attention runs in the r-dim latent.
    Scores = (q_nope·W_uk)·c_kv + q_rope·k_rope, divided by
    sqrt(qk_nope + qk_rope); output = (probs·c_kv)·W_uv. x: (B,1,d);
    cache c_kv (B,S_max,r), k_rope (B,S_max,qk_r); ``pos`` a scalar or one
    per row, written and masked per row as in ``gqa_decode``."""
    B = x.shape[0]
    H, r = cfg.n_heads, cfg.kv_lora_rank
    qk_n, qk_r, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    dt = x.dtype
    S_max = cache["c_kv"].shape[1]
    pos = row_positions(pos, B, x.device)
    positions = pos[:, None]

    q = (x @ params["wq"].to(dt)).reshape(B, 1, H, qk_n + qk_r)
    q_rope = apply_rope(q[..., qk_n:], positions, cfg.rope_theta)[:, 0]     # (B,H,qk_r)
    q_nope = q[:, 0, :, :qk_n]                                              # (B,H,qk_n)
    kv_a = (x @ params["wkv_a"].to(dt))[:, 0]                               # (B,r+qk_r)
    c_new = kv_a[..., :r]
    kr_new = apply_rope(kv_a[..., r:][:, None, None, :], positions, cfg.rope_theta)[:, 0, 0]

    idx, write, valid_len = _ring(pos, S_max, cfg)
    write = write[:, :, None]                                               # (B,S_max,1)
    c_kv = torch.where(write, c_new[:, None].to(cache["c_kv"].dtype), cache["c_kv"])
    k_rope = torch.where(write, kr_new[:, None].to(cache["k_rope"].dtype), cache["k_rope"])

    wkv_b = params["wkv_b"].to(dt).reshape(r, H, qk_n + dv)
    w_uk, w_uv = wkv_b[..., :qk_n], wkv_b[..., qk_n:]                       # (r,H,qk_n), (r,H,dv)
    q_lat = torch.einsum("bhn,rhn->bhr", q_nope, w_uk)                      # absorbed query
    scores = torch.einsum("bhr,bsr->bhs", q_lat, c_kv.to(dt))
    scores = scores + torch.einsum("bhp,bsp->bhs", q_rope, k_rope.to(dt))
    scores = scores.to(torch.float32) / float(np.sqrt(np.float32(qk_n + qk_r)))
    mask = (idx[None, :] < valid_len[:, None])[:, None, :]                  # (B,1,S_max)
    probs = torch.softmax(torch.where(mask, scores, _NEG), dim=-1).to(dt)
    ctx_lat = torch.einsum("bhs,bsr->bhr", probs, c_kv.to(dt))              # latent context
    out = torch.einsum("bhr,rhv->bhv", ctx_lat, w_uv).reshape(B, 1, H * dv)
    return out @ params["wo"].to(dt), {"c_kv": c_kv, "k_rope": k_rope}


# =========================================================== cross-attn
def cross_attn_init(generator: torch.Generator, cfg, dtype=torch.float32, device="cpu"):
    hd = cfg.resolved_head_dim
    return {
        "wq": dense_init(generator, cfg.d_model, cfg.n_heads * hd, dtype, device=device),
        "w_cross_k": dense_init(generator, cfg.d_model, cfg.n_kv_heads * hd, dtype, device=device),
        "w_cross_v": dense_init(generator, cfg.d_model, cfg.n_kv_heads * hd, dtype, device=device),
        "wo": dense_init(generator, cfg.n_heads * hd, cfg.d_model, dtype, device=device),
    }


def cross_kv(params, enc_out, cfg):
    """The encoder output's keys and values for one decoder layer:
    ``{"k", "v": (B, Se, H_kv, hd)}`` in ``enc_out``'s dtype."""
    hd = cfg.resolved_head_dim
    dt = enc_out.dtype
    k = split_heads(enc_out @ params["w_cross_k"].to(dt), cfg.n_kv_heads, hd)
    v = split_heads(enc_out @ params["w_cross_v"].to(dt), cfg.n_kv_heads, hd)
    return {"k": shard(k, "batch", None, "tp", None), "v": shard(v, "batch", None, "tp", None)}


def _attend_all(q, k, v):
    """Unmasked attention of q (B,Sq,H,hd) over every key of k, v
    (B,Sk,H_kv,hd): logits scaled by 1/sqrt(hd) and the softmax in fp32.
    Returns (B, Sq, H·hd) in q's dtype."""
    B, Sq, H, hd = q.shape
    (q, k, v), wrap = local_heads(q, _repeat_kv(k.to(q.dtype), H), _repeat_kv(v.to(q.dtype), H))
    logits = torch.einsum("bqhd,bshd->bhqs", q, k).to(torch.float32) * _scale(hd)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return merge_heads(wrap(torch.einsum("bhqs,bshd->bqhd", probs, v)))


def cross_attend(params, x, kv, cfg):
    """x (B, Sq, d) queries over precomputed encoder keys and values (no
    RoPE, no mask)."""
    dt = x.dtype
    q = split_heads(x @ params["wq"].to(dt), cfg.n_heads, cfg.resolved_head_dim)
    q = shard(q, "batch", None, "tp", None)
    return _attend_all(q, kv["k"], kv["v"]) @ params["wo"].to(dt)


def bidir_attention(params, x, cfg):
    """Encoder self-attention over GQA weights: RoPE on q and k, no mask."""
    B, S, _ = x.shape
    q, k, v = _qkv(params, x, cfg, _positions(B, S, x.device))
    return _attend_all(q, k, v) @ params["wo"].to(x.dtype)
