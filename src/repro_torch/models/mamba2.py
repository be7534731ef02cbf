"""Mamba-2 (SSD) block — attention-free sequence mixing.

The port's counterpart of the JAX package's ``models/mamba2.py``.
Projections are stored unpacked (wz/wx/wb/wc/wdt); B and C are shared by a
sequence's heads (G = 1), or by each of ``ssm_groups`` groups of H / G
consecutive heads (Nemotron-H: G 8, B and C [B·G, S, N] straight into the
scan, the gated norm's RMS taken over each group's di / G channels).
With ``ssm_conv_bc`` the causal conv and SiLU run over B and C too
(``conv_silu_heads`` with heads = G writes them in the scan's grouped
layout), and each of the three convs adds its bias.  The sequence mix runs through
``kernels.ssd.ssd_chunked``: the hand-written kernel on the card, its plain
version on the CPU.  The kernel reads B and C once per sequence, where the
reference broadcasts them H-fold in memory.  The mixer's conv, SiLU,
dskip add, gate and norm run through ``kernels.mamba_glue``
(``conv_silu_heads`` before the scan, ``skip_gate_norm`` after it): two
fused kernels with their gradients on the card, the plain statements of
``kernels/mamba_glue/ref.py`` on the CPU.  Decode keeps a [B·H, P, N] state
and a depthwise-conv tail instead of a KV cache.

As in the reference, the prefill convolution applies tap 0 to the current
token and the decode step applies tap K-1 to it (ROADMAP, queue 3); the port
copies both.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import mamba_glue
from repro_torch.kernels.mamba_glue.ref import gated_norm, to_heads, to_tokens
from repro_torch.kernels.ssd import ssd_chunked, ssd_decode_step
from .config import ModelConfig, ShardingPlan
from .layers import dense_init, matmul

__all__ = ["init_mamba", "apply_mamba", "init_mamba_state", "decode_mamba"]


#: the convs' leaves: (taps, bias) of x, B and C
_CONVS = {"x": ("conv_w", "conv_b"), "b": ("bconv_w", "bconv_b"), "c": ("cconv_w", "cconv_b")}


def init_mamba(gen: torch.Generator, cfg: ModelConfig,
               plan: Optional[ShardingPlan] = None) -> Dict[str, torch.Tensor]:
    del plan
    d, di, n, h = cfg.d_model, cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads
    gn = cfg.ssm_groups * n
    dev, f32 = gen.device, torch.float32
    convs = {}
    if cfg.ssm_conv_bc:                      # taps of B's and C's convs, a bias for all three
        for part in ("b", "c"):
            convs[_CONVS[part][0]] = torch.randn((gn, cfg.ssm_conv), generator=gen,
                                                 dtype=f32, device=dev) * 0.1
        for part, width in (("x", di), ("b", gn), ("c", gn)):
            convs[_CONVS[part][1]] = torch.zeros((width,), dtype=f32, device=dev)
    return {
        **convs,
        "wz": dense_init(gen, (d, di)),
        "wx": dense_init(gen, (d, di)),
        "wb": dense_init(gen, (d, gn)),
        "wc": dense_init(gen, (d, gn)),
        "wdt": dense_init(gen, (d, h), dtype=f32),
        "conv_w": torch.randn((di, cfg.ssm_conv), generator=gen, dtype=f32,
                              device=dev) * 0.1,
        "a_log": torch.zeros((h,), dtype=f32, device=dev),   # A = -exp(a_log) = -1
        "dskip": torch.ones((h,), dtype=f32, device=dev),
        "dt_bias": torch.zeros((h,), dtype=f32, device=dev),
        "norm_g": torch.ones((di,), dtype=f32, device=dev),
        "wo": dense_init(gen, (di, d), fan_in=di),
    }


def _gated_norm(y, z, params, cfg: ModelConfig, dtype):
    return gated_norm(y, z, params["norm_g"], cfg.norm_eps, dtype)


def _conv(params, cfg: ModelConfig, part: str, pre: torch.Tensor, heads: int):
    """The causal conv and SiLU of ``pre`` [B, S, heads·P], written in the
    scan's [B·heads, S, P] layout."""
    w, bias = _CONVS[part]
    return mamba_glue.conv_silu_heads(pre, params[w], heads,
                                      params[bias] if cfg.ssm_conv_bc else None)


def _bc(params, cfg: ModelConfig, x: torch.Tensor, name: str):
    """B or C: [B, S, N] (one group, no conv) or [B·G, S, N]."""
    g = cfg.ssm_groups
    pre = matmul(x, params["w" + name])
    if cfg.ssm_conv_bc:
        return _conv(params, cfg, name, pre, g)
    return pre if g == 1 else to_heads(pre, g)


def apply_mamba(params, cfg: ModelConfig, x: torch.Tensor, *, chunk: int = 128,
                return_state: bool = False):
    bsz, s, d = x.shape
    h = cfg.ssm_heads
    f32 = torch.float32
    if return_state and (cfg.ssm_groups > 1 or cfg.ssm_conv_bc):
        raise NotImplementedError("the prefill state of a grouped mixer or one that "
                                  "convolves B and C (serving is not ported for it)")
    z = matmul(x, params["wz"])
    # the causal conv and SiLU, written in the scan's [B·H, S, P] layout
    xh = _conv(params, cfg, "x", matmul(x, params["wx"]), h)
    b = _bc(params, cfg, x, "b")
    c = _bc(params, cfg, x, "c")
    dt = F.softplus(matmul(x.to(f32), params["wdt"]) + params["dt_bias"])
    dth = dt.transpose(1, 2).reshape(bsz * h, s)
    a = -torch.exp(params["a_log"][None].expand(bsz, h).reshape(-1))
    ch_len = min(chunk, s) if s % min(chunk, s) == 0 else s
    out = ssd_chunked(xh, dth, a, b, c, chunk=ch_len, return_state=return_state)
    y, final_state = out if return_state else (out, None)          # [BH, S, P]
    # the dskip add, back to token order, the gated norm
    y = mamba_glue.skip_gate_norm(y, xh, z, params["dskip"], params["norm_g"], cfg.norm_eps,
                                  cfg.ssm_groups)
    out = matmul(y, params["wo"])
    if return_state:
        k1 = cfg.ssm_conv - 1
        xi = to_tokens(xh[:, -k1:], bsz)             # the conv's last K-1 rows
        conv_tail = xi if s >= k1 else F.pad(xi, (0, 0, k1 - s, 0))
        return out, {"ssm": final_state, "conv": conv_tail}
    return out


# ------------------------------------------------------------------ decode

def init_mamba_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device=None) -> Dict[str, torch.Tensor]:
    h, p, n, di = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_inner
    return {
        "ssm": torch.zeros((batch * h, p, n), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, di), dtype=dtype, device=device),
    }


def decode_mamba(params, cfg: ModelConfig, state, x: torch.Tensor):
    """One-token step.  x [B, 1, d] -> (state, y [B, 1, d])."""
    bsz = x.shape[0]
    h, p, n = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    f32 = torch.float32
    z = matmul(x, params["wz"])[:, 0]
    xi = matmul(x, params["wx"])[:, 0]                                # [B, di]
    window = torch.cat([state["conv"], xi[:, None].to(state["conv"].dtype)], dim=1)
    xc = torch.einsum("bki,ik->bi", window.to(f32), params["conv_w"])
    xc = F.silu(xc).to(x.dtype)
    new_conv = window[:, 1:]
    b = matmul(x, params["wb"])[:, 0]
    c = matmul(x, params["wc"])[:, 0]
    dt = F.softplus(matmul(x.to(f32), params["wdt"])[:, 0] + params["dt_bias"])
    xh = xc.reshape(bsz * h, p).to(f32)
    bh = b[:, None].expand(bsz, h, n).reshape(bsz * h, n).to(f32)
    chh = c[:, None].expand(bsz, h, n).reshape(bsz * h, n).to(f32)
    dth = dt.reshape(bsz * h)
    a = -torch.exp(params["a_log"][None].expand(bsz, h).reshape(-1))
    ssm, yh = ssd_decode_step(state["ssm"], xh, dth, a, bh, chh)
    yh = yh + xh * params["dskip"][None].expand(bsz, h).reshape(-1)[:, None]
    y = yh.reshape(bsz, h * p).to(x.dtype)
    y = _gated_norm(y, z, params, cfg, x.dtype)
    out = matmul(y, params["wo"])[:, None]
    return {"ssm": ssm, "conv": new_conv}, out
