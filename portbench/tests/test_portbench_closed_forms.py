"""The closed forms of the per-layer metrics against counts by hand at both
cells' shapes."""

from __future__ import annotations

import pytest

from portbench import spec
from portbench.metrics import flash_bwd_roofline, flash_fwd_roofline, ssd_bwd_roofline
from portbench.metrics import ssd_fwd_roofline, train_mfu
from portbench.metrics._kernels import Reading


def _model(cell):
    return spec.cell(cell).config["model"]


def test_mamba_matrix_params_by_hand():
    m = _model("mamba2-780m.train_8k")
    d, di, n, heads, k, v = 1536, 3072, 128, 48, 4, 50280
    per_layer = (d * di          # wz
                 + d * di        # wx
                 + d * n * 2     # wb, wc
                 + d * heads     # wdt
                 + di * k        # depthwise conv
                 + di * d)       # wo
    assert per_layer == 14_635_008
    assert train_mfu.matrix_params(m) == 48 * per_layer + d * v == 779_710_464
    assert abs(train_mfu.matrix_params(m) / 779.8e6 - 1) < 2e-4
    assert 6 * train_mfu.matrix_params(m) / 1e9 == pytest.approx(4.678, abs=1e-3)
    assert train_mfu.attention_flop_per_token(m, 8192) == 0.0


def test_mistral_matrix_params_by_hand():
    m = _model("mistral-nemo-12b.train_16k")
    d, hq, hkv, hd, ff, v = 5120, 32, 8, 128, 14336, 131072
    attn = d * hq * hd + 2 * d * hkv * hd + hq * hd * d
    mlp = 3 * d * ff
    assert attn + mlp == 272_629_760
    # 10 of the 40 layers and a quarter of the unembedding (no embedding table)
    assert train_mfu.matrix_params(m) == 10 * (attn + mlp) + d * 32768 == 2_894_069_760
    assert 6 * train_mfu.matrix_params(m) / 1e9 == pytest.approx(17.364, abs=1e-3)
    # the issue's count, with the whole vocabulary: N 2.034 B, 12.20 GFLOP a token
    assert 5 * (attn + mlp) + d * v == 2_034_237_440
    # causal attention: 6 x L x H x D x S a token, S = 16,384
    assert train_mfu.attention_flop_per_token(m, 16384) == 6 * 10 * 32 * 128 * 16384
    assert train_mfu.attention_flop_per_token(m, 16384) / 1e9 == pytest.approx(4.027, abs=1e-3)
    # at the issue's 5 layers: 2.013 GFLOP a token
    assert 6 * 5 * 32 * 128 * 16384 / 1e9 == pytest.approx(2.013, abs=1e-3)


def _reading(cell, kernels, steps=2, window_s=2.0):
    c = spec.cell(cell)
    return Reading(kernels=kernels, steps=steps, window_s=window_s, busy_s=1.9,
                   trace_window_s=2.0, model=c.config["model"], traffic=c.workload["traffic"])


def test_train_mfu_is_useful_flop_over_peak_time():
    r = _reading("mistral-nemo-12b.train_16k", {}, steps=3, window_s=3.0)
    per_token = 6 * 2_894_069_760 + 6 * 10 * 32 * 128 * 16384
    assert train_mfu.read(r) == pytest.approx(100 * 16384 * per_token / 989.4e12)


def test_flash_counts_by_hand():
    s, b, hq, hkv, d = 16384, 1, 32, 8, 128
    pairs = s * (s + 1) // 2
    assert flash_fwd_roofline.flop(b, hq, s, d) == 4 * hq * d * pairs
    assert flash_bwd_roofline.flop(b, hq, s, d) == 2 * flash_fwd_roofline.flop(b, hq, s, d)
    # q, k, v read and o written in bf16, the log-sum-exp in float32
    assert flash_fwd_roofline.moved(b, hq, hkv, s, d) == (
        2 * (hq * s * d + 2 * hkv * s * d + hq * s * d) + 4 * hq * s)
    # q, k, v, o, dO and lse read; dq, dk, dv written
    assert flash_bwd_roofline.moved(b, hq, hkv, s, d) == (
        2 * (3 * hq * s * d + 2 * hkv * s * d) + 4 * hq * s + 2 * (hq * s * d + 2 * hkv * s * d))


def test_ssd_counts_by_hand():
    # the cheapest chunk at S 8,192, P 64, N 128 (PERF.md row 8: 5.72e10 FLOP at BH 192)
    assert 192 * ssd_fwd_roofline.head_flop(8192, 64, 128) == pytest.approx(5.72e10, rel=2e-3)
    bh, g, s, p, n = 96, 2, 8192, 64, 128
    assert ssd_fwd_roofline.moved(bh, g, s, p, n) == (2 * bh * s * p * 2 + bh * s * 4 + bh * 4
                                                     + 2 * g * s * n * 2)
    assert ssd_bwd_roofline.flop(bh, s, p, n) == 2 * ssd_fwd_roofline.flop(bh, s, p, n)


def test_roofline_reads_calls_from_the_trace_and_stays_silent_without_kernels():
    r = _reading("mistral-nemo-12b.train_16k", {})
    assert flash_fwd_roofline.read(r) is None
    b, hq, hkv, s, d = 1, 32, 8, 16384, 128
    least = max(flash_fwd_roofline.flop(b, hq, s, d) / 989.4e12,
                flash_fwd_roofline.moved(b, hq, hkv, s, d) / 3.35e12)
    kernels = {"void flash_fwd<__nv_bfloat16, 128, 128>(...)": (0.001 * 10, 10),
               "void wg::flash_wgmma<wg::Cfg128>(...)": (0.009 * 10, 10),
               "void wg::bwd_kv_wgmma<wg::Bwd128>(...)": (1.0, 5)}
    r = _reading("mistral-nemo-12b.train_16k", kernels)
    assert flash_fwd_roofline.read(r) == pytest.approx(100 * 10 * least / 0.1)
    assert ssd_fwd_roofline.read(r) is None
