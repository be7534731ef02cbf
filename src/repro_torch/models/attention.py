"""GQA attention with RoPE / M-RoPE (or none: ``use_rope=False``, as
Nemotron-H's attention layers), the blockwise (flash) path, and KV-cache
decode.

The port's counterpart of the JAX package's ``models/attention.py``.
Implementation selection, as in the reference:

  * ``plain``      — full [S, T] score materialisation (small S only)
  * ``blockwise``  — online softmax over key blocks: on the card the
                     hand-written kernel (``kernels/flash_attention``), on
                     the CPU its plain PyTorch version
  * ``auto``       — blockwise when S >= 8192

Decode reads a KV cache laid out [B, Hkv, S_max, hd].  The cache write
clamps its start to ``S_max - 1`` as ``jax.lax.dynamic_update_slice`` does,
so a slot running past ``S_max`` behaves as in the reference; the position
is a device scalar, so no step waits on the host.  Caches are returned as
new tensors (the reference's functional update), not written in place.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.flash_attention import flash_attention
from .config import ModelConfig, ShardingPlan
from .layers import dense_init, matmul

__all__ = ["init_attention", "apply_attention", "decode_attention", "rope", "mrope",
           "plain_attention", "blockwise_attention"]

NEG_INF = -1e30


# ------------------------------------------------------------------- RoPE

def _freqs(dim: int, theta: float, device) -> torch.Tensor:
    """``1 / theta ** (2i / dim)`` rounded once to float32.  The reference
    writes it in float32, but its operands are constants, so XLA folds the
    expression at compile time and rounds only the result; in float32 the
    power's own rounding changed a third of the frequencies by an ulp."""
    exponent = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return (1.0 / (theta ** exponent.double())).float()


def _rope_angles(positions: torch.Tensor, dim: int, theta: float):
    """positions [...] -> cos/sin [..., dim/2]."""
    ang = positions.to(torch.float32)[..., None] * _freqs(dim, theta, positions.device)
    return torch.cos(ang), torch.sin(ang)


def _apply_rot(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [..., d] rotated as its (x1, x2) halves."""
    d = x.shape[-1]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def rope(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor, theta: float):
    """q/k [B, H, S, hd]; positions [B, S]."""
    cos, sin = _rope_angles(positions, q.shape[-1], theta)       # [B, S, hd/2]
    cos, sin = cos[:, None], sin[:, None]
    return _apply_rot(q, cos, sin), _apply_rot(k, cos, sin)


def mrope(q, k, positions3, theta, sections: Tuple[int, int, int]):
    """Qwen2-VL multimodal RoPE: positions3 [B, 3, S] (t, h, w) with the
    rotary dim split into per-modality sections."""
    hd = q.shape[-1]
    freqs = _freqs(hd, theta, q.device)
    cos_parts, sin_parts = [], []
    start = 0
    for comp, sec in enumerate(sections):
        ang = positions3[:, comp].to(torch.float32)[..., None] * freqs   # [B, S, half]
        cos_parts.append(torch.cos(ang[..., start:start + sec]))
        sin_parts.append(torch.sin(ang[..., start:start + sec]))
        start += sec
    cos = torch.cat(cos_parts, -1)[:, None]                     # [B, 1, S, half]
    sin = torch.cat(sin_parts, -1)[:, None]
    return _apply_rot(q, cos, sin), _apply_rot(k, cos, sin)


# ------------------------------------------------------------------- params

def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   plan: Optional[ShardingPlan] = None) -> Dict[str, torch.Tensor]:
    del plan
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {
        "wq": dense_init(gen, (d, hq * hd)),
        "wk": dense_init(gen, (d, hkv * hd)),
        "wv": dense_init(gen, (d, hkv * hd)),
        "wo": dense_init(gen, (hq * hd, d), fan_in=hq * hd),
    }


def _project(params, x, cfg: ModelConfig):
    b, s, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = matmul(x, params["wq"]).reshape(b, s, hq, hd).transpose(1, 2)
    k = matmul(x, params["wk"]).reshape(b, s, hkv, hd).transpose(1, 2)
    v = matmul(x, params["wv"]).reshape(b, s, hkv, hd).transpose(1, 2)
    return q, k, v


def _group_q(q, hkv):
    """[B, Hq, S, D] -> [B, Hkv, R, S, D]: GQA without expanding KV."""
    b, hq, s, d = q.shape
    return q.reshape(b, hkv, hq // hkv, s, d)


def plain_attention(q, k, v, *, causal: bool, window: int = 0) -> torch.Tensor:
    b, hq, sq, hd = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    q5 = _group_q(q, hkv)
    s = torch.einsum("bkrsd,bktd->bkrst", q5.float(), k.float()) / (hd ** 0.5)
    rows = torch.arange(sq, device=q.device)[:, None] + (tk - sq)
    cols = torch.arange(tk, device=q.device)[None, :]
    if causal:
        s = s.masked_fill(rows < cols, NEG_INF)
    if window:
        s = s.masked_fill(rows - cols >= window, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)       # P in the input dtype, f32 accum
    o = torch.einsum("bkrst,bktd->bkrsd", p.float(), v.float())
    return o.reshape(b, hq, sq, hd).to(q.dtype)


def blockwise_attention(q, k, v, *, causal: bool = True, block_q: int = 512,
                        block_k: int = 1024, window: int = 0,
                        unroll: bool = False) -> torch.Tensor:
    """Flash attention: the hand-written kernel on CUDA tensors, its plain
    version (tiled by ``block_q``/``block_k``) on CPU tensors.  ``unroll``
    is an XLA lowering knob of the reference and changes nothing here."""
    del unroll
    return flash_attention(q, k, v, causal=causal, window=window,
                           block_q=block_q, block_k=block_k)


def apply_attention(
    params,
    cfg: ModelConfig,
    x: torch.Tensor,                       # [B, S, d]
    positions,                             # [B, S] or [B, 3, S] for mrope
    *,
    impl: Optional[str] = None,
    window: int = 0,
    return_kv: bool = False,
):
    b, s, d = x.shape
    q, k, v = _project(params, x, cfg)
    if cfg.mrope:
        q, k = mrope(q, k, positions, cfg.rope_theta, cfg.mrope_sections)
    elif cfg.use_rope:
        q, k = rope(q, k, positions, cfg.rope_theta)
    impl = impl or cfg.attn_impl
    if impl == "auto":
        impl = "blockwise" if s >= 8192 else "plain"
    if impl == "blockwise":
        bq = 2048 if cfg.attn_unroll else 512
        bk = 4096 if cfg.attn_unroll else 1024
        o = blockwise_attention(q, k, v, causal=True, window=window,
                                block_q=bq, block_k=bk)
    else:
        o = plain_attention(q, k, v, causal=True, window=window)
    o = o.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.hd)
    out = matmul(o, params["wo"])
    if return_kv:
        return out, k, v                   # rotated k, raw v, Hkv heads
    return out


# ------------------------------------------------------------------- decode

def _write_cache(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``dynamic_update_slice_in_dim(cache, new, pos, axis=2)`` for one
    token: the start is clamped into [0, S_max - 1]."""
    idx = pos.clamp(0, cache.shape[2] - 1).reshape(1).to(torch.long)
    return cache.index_copy(2, idx, new.to(cache.dtype))


def decode_attention(
    params,
    cfg: ModelConfig,
    x: torch.Tensor,                # [B, 1, d]
    cache_k: torch.Tensor,          # [B, Hkv, S_max, hd]
    cache_v: torch.Tensor,
    pos: torch.Tensor,              # [] int32 — current position
    positions_q,                    # [B, 1] (or [B, 3, 1] mrope)
    *,
    window: int = 0,
    ring: bool = False,             # cache is a ring buffer of size window
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode with cache update.  Returns (out, cache_k, cache_v)."""
    b = x.shape[0]
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q, k_new, v_new = _project(params, x, cfg)      # [B, H, 1, hd]
    if cfg.mrope:
        q, k_new = mrope(q, k_new, positions_q, cfg.rope_theta, cfg.mrope_sections)
    elif cfg.use_rope:
        q, k_new = rope(q, k_new, positions_q, cfg.rope_theta)
    cache_k = _write_cache(cache_k, k_new, pos)
    cache_v = _write_cache(cache_v, v_new, pos)
    s_max = cache_k.shape[2]
    q5 = _group_q(q, hkv)                                # [B, Hkv, R, 1, hd]
    sc = torch.einsum("bkrqd,bktd->bkrqt", q5.float(), cache_k.float()) / (hd ** 0.5)
    t_idx = torch.arange(s_max, device=x.device)
    if ring:
        # ring buffer: every slot holds a token from the last `s_max` steps
        valid = (t_idx <= pos) | (pos >= s_max)
    else:
        valid = t_idx <= pos
        if window:
            valid = valid & (t_idx > pos - window)
    sc = torch.where(valid, sc, torch.full_like(sc, NEG_INF))
    p = torch.softmax(sc, dim=-1).to(cache_v.dtype)
    o = torch.einsum("bkrqt,bktd->bkrqd", p.float(), cache_v.float()).to(x.dtype)
    o = o.reshape(b, hq, 1, hd).transpose(1, 2).reshape(b, 1, hq * hd)
    return matmul(o, params["wo"]), cache_k, cache_v
