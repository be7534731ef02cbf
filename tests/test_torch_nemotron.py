"""NVIDIA Nemotron-3-Nano-30B-A3B in the port: the layer pattern (Mamba-2,
dropless MoE, NoPE attention), grouped SSD, the conv with a bias over x, B
and C, and the expert layer that holds some of the experts.

Contract, on the CPU at a small size (d 64, pattern ``ME*ME``, 16 experts
with 4 held, top-6 replaced by the config's, G 2, vocab 512; no JAX):

- the program's loss and every gradient leaf hold to the benchmark's plain
  reference (``portbench/reference/nemotron_h.py``) on seeded weights;
- the dropless layer's shares add up: the four devices' parts of the routed
  sum, with the shared expert counted once, are the uncut layer, which is
  the reference's; nothing is dropped;
- the capacity path of ``apply_moe`` gives, on a fixed seed, the numbers
  the commit before the dropless layer gave;
- the published configuration module is the model and is not registered,
  and the benchmark's configuration is the last stage of it;
- attention without RoPE, serving's refusal of a pattern, the spans of the
  MoE layer, and the closed forms of ``hybrid_moe_train_mfu`` against the
  program's own parameter tree.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib

import pytest
import torch

from portbench import weights
from portbench.drivers.train import flat, nest, per_layer
from portbench.metrics import hybrid_moe_train_mfu
from portbench.reference import nemotron_h as R
from portbench.reference.common import Prec, tf32_off
from repro_torch import spans
from repro_torch.configs import get_smoke
from repro_torch.configs.nemotron3_nano_30b_a3b import CONFIG, PATTERN
from repro_torch.configs.registry import all_arch_names
from repro_torch.launch.specs import abstract_params
from repro_torch.models import SINGLE_POD_PLAN
from repro_torch.models import attention as A
from repro_torch.models import moe
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.train import TrainSpec, adamw, make_train_step
from repro_torch.train.train_step import value_and_grad

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH_CONFIG = ROOT / "portbench" / "configs" / "nemotron3-nano-30b-a3b.json"
F32 = torch.float32
#: the small model: every width cut, every mechanism kept
SMALL = dict(n_layers=5, layer_pattern="ME*ME", d_model=64, n_heads=4, n_kv_heads=2,
             head_dim=16, d_ff=32, moe_shared_ff=64, vocab=512, ssm_state=16, ssm_headdim=16,
             ssm_nheads=8, ssm_groups=2, moe_experts=16, moe_held=4, moe_held_first=4,
             dtype="float32", remat="block")
#: the benchmark's init rules, with the matrices drawn wider so that the
#: small model's routing and attention are far from uniform
WIDER = {"w1": "normal:0.2", "w2": "normal:0.2", "shared_w1": "normal:0.2",
         "shared_w2": "normal:0.1", "router": "normal:0.3", "wq": "normal:0.3",
         "wk": "normal:0.3"}
#: the program against the reference in float32: the same operations in a
#: different order (the SSD scan's layout, the conv's sums, the experts'
#: sums back to token order), so round-off of float32 sums over a few hundred
#: terms; one run read 0 on the loss and 1.8e-6 on the worst gradient leaf
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bench() -> dict:
    return json.loads(BENCH_CONFIG.read_text())


def _small(**kw):
    """(model block, ModelConfig, seeded float32 leaves)."""
    model = dict(_bench()["model"], **dict(SMALL, **kw))
    cfg = ModelConfig(**model)
    meta, _ = abstract_params(cfg, SINGLE_POD_PLAN)
    layout = {k: (tuple(v.shape), F32 if v.dtype == torch.bfloat16 else v.dtype)
              for k, v in flat(meta).items()}
    leaves = weights.make(layout, dict(_bench()["init"], **WIDER), 3, "cpu")
    return model, cfg, leaves


def _batch(seed=5, b=2, s=64, d=64, vocab=512):
    g = torch.Generator().manual_seed(seed)
    return {"embeddings": torch.randn(b, s, d, generator=g),
            "labels": torch.randint(0, vocab, (b, s), generator=g)}


def _rel(a, b) -> float:
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


@pytest.mark.parametrize("remat", ["block", "none"])
def test_loss_and_gradients_match_the_plain_reference(remat):
    model, cfg, leaves = _small(remat=remat)
    batch = _batch()
    grad_fn = value_and_grad(lambda p, b: T.loss_fn(p, cfg, SINGLE_POD_PLAN, None, b))
    (loss, metrics), grads = grad_fn(nest(leaves), batch)
    ref_leaves = {k: v.clone().requires_grad_(True) for k, v in per_layer(leaves).items()}
    with tf32_off():
        ref_loss = R.loss(ref_leaves, model, batch, Prec.F32)
        ref_grads = torch.autograd.grad(ref_loss, list(ref_leaves.values()))
    got_loss, want_loss = float(loss.detach()), float(ref_loss.detach())
    assert abs(got_loss - want_loss) <= LOSS_TOL * abs(want_loss)
    got = per_layer(flat(grads))
    assert set(got) == set(ref_leaves)
    for name, want in zip(ref_leaves, ref_grads):
        if name.endswith("e_bias"):                       # chooses experts, no gradient
            assert not got[name].any() and not want.any(), name
            continue
        assert float(want.norm()) > 0, name
        assert _rel(got[name], want) <= GRAD_TOL, (name, _rel(got[name], want))
    assert tuple(metrics["expert_load"].shape) == (2, 4)


@pytest.mark.parametrize("remat", ["block", "none"])
def test_stacked_leaves_take_their_gradient_in_one_stack(remat):
    """Each stacked leaf is split once a forward: its gradient is one
    ``UnbindBackward0`` over the layers, never a select per layer (which
    writes a zero gradient the size of the whole stack for each layer)."""
    _, cfg, leaves = _small(remat=remat)
    params = {k: v.requires_grad_(True) for k, v in leaves.items()}
    loss, _ = T.loss_fn(nest(params), cfg, SINGLE_POD_PLAN, None, _batch())
    stacked = {id(v) for k, v in params.items()                 # the correction bias
               if k.startswith("layers.") and not k.endswith("e_bias")}   # only chooses
    takers, seen, todo = {}, set(), [loss.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        for nxt, _ in node.next_functions:
            if nxt is not None and id(getattr(nxt, "variable", None)) in stacked:
                takers.setdefault(id(nxt.variable), []).append(node.name())
            todo.append(nxt)
    assert set(takers) == stacked
    assert all(names == ["UnbindBackward0"] for names in takers.values()), takers


def _layer(cfg, leaves, first, held):
    lp = {k.split(".", 2)[2]: v[0] for k, v in leaves.items() if k.startswith("layers.moe.")}
    lp["w1"], lp["w2"] = lp["w1"][first:first + held], lp["w2"][first:first + held]
    return dataclasses.replace(cfg, moe_held_first=first, moe_held=held), lp


def test_dropless_shares_add_up_to_the_uncut_layer():
    model, cfg, leaves = _small(moe_held=16, moe_held_first=0)
    x = _batch()["embeddings"]
    whole_cfg, whole = _layer(cfg, leaves, 0, 16)
    y_whole, aux = moe.apply_dropless(whole, whole_cfg, x)
    assert int(aux["expert_load"].sum()) == x.shape[0] * x.shape[1] * cfg.moe_topk
    parts, shared = [], None
    for first in range(0, 16, 4):
        c, lp = _layer(cfg, leaves, first, 4)
        y, aux = moe.apply_dropless(lp, c, x)
        parts.append(y)
        if shared is None:                                # the routed part scaled to 0
            shared = moe.apply_dropless(lp, dataclasses.replace(c, moe_scale=0.0), x)[0]
    total = sum(parts) - 3 * shared
    assert torch.allclose(total, y_whole, rtol=1e-5, atol=1e-5)
    # the uncut layer is the reference's, all 16 experts held
    mp = [whole[k] for k in R.KEYS["moe"][1:]]
    with tf32_off():
        want = R._moe(dict(model, moe_held_first=0), Prec.F32, x, torch.ones(64), *mp)
    h = x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + cfg.norm_eps)
    got = x + moe.apply_dropless(whole, whole_cfg, h)[0]
    assert _rel(got, want) <= 1e-5


def test_dropless_layer_makes_no_host_copy_of_the_loads():
    _, cfg, leaves = _small()                            # experts 4-7 held
    _, lp = _layer(cfg, leaves, 0, 4)
    y, aux = moe.apply_dropless(lp, cfg, _batch()["embeddings"])
    assert aux["expert_load"].dtype == torch.int32 and tuple(aux["expert_load"].shape) == (4,)
    assert y.shape == (2, 64, 64)


def test_capacity_moe_is_unchanged_on_a_fixed_seed():
    """The capacity path's outputs on the smoke qwen3-moe, read on the
    commit before the dropless layer was added."""
    cfg = get_smoke("qwen3-moe-235b-a22b")
    p = moe.init_moe(torch.Generator().manual_seed(11), cfg)
    x = torch.randn((2, 24, cfg.d_model), generator=torch.Generator().manual_seed(12))
    y, aux = moe.apply_moe(p, cfg, SINGLE_POD_PLAN, None, x.to(torch.bfloat16))
    assert aux["expert_load"].tolist() == [13, 14, 11, 8, 10, 20, 10, 10]
    assert float(aux["drop_frac"]) == 0.05208331346511841
    assert float(aux["aux_loss"]) == 1.035164475440979
    assert float(y.double().sum()) == -25.37970542907715
    assert float(y.double().abs().sum()) == 1996.5302639007568


def test_config_module_is_the_published_model_and_unregistered():
    assert CONFIG.name not in all_arch_names()
    assert CONFIG.kinds.count("mamba") == 23 and CONFIG.kinds.count("moe") == 23
    assert CONFIG.kinds.count("attn") == 6 and len(PATTERN) == 52
    assert (CONFIG.ssm_inner, CONFIG.ssm_heads, CONFIG.hd) == (4096, 64, 128)
    assert abs(CONFIG.param_count() - 31.6e9) < 0.01 * 31.6e9


def test_benchmark_config_is_the_last_stage_of_the_published_model():
    doc = _bench()
    m = doc["model"]
    assert m["layer_pattern"] == PATTERN[26:] and m["n_layers"] == 26
    assert (m["moe_experts"], m["moe_held"], m["moe_topk"]) == (128, 8, 6)
    assert m["vocab"] == doc["vocab_size"] == 65536 == CONFIG.vocab // 2
    stage = ModelConfig(**m)
    for key in ("d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff", "moe_shared_ff",
                "ssm_state", "ssm_headdim", "ssm_nheads", "ssm_groups", "ssm_conv",
                "ssm_conv_bc", "use_rope", "moe_scale", "norm_eps"):
        assert getattr(stage, key) == getattr(CONFIG, key), key
    assert set(doc["reduced"]) == {"num_hidden_layers", "n_routed_experts", "vocab_size"}
    assert doc["hybrid_override_pattern"] == PATTERN


def test_attention_without_rope_is_rope_at_position_zero():
    cfg = dataclasses.replace(get_smoke("llama3.2-1b"), use_rope=False)
    p = A.init_attention(torch.Generator().manual_seed(0), cfg)
    x = torch.randn((2, 16, cfg.d_model), generator=torch.Generator().manual_seed(1))
    pos = torch.arange(16)[None].expand(2, 16)
    got = A.apply_attention(p, cfg, x, pos)
    want = A.apply_attention(p, dataclasses.replace(cfg, use_rope=True), x,
                             torch.zeros_like(pos))
    assert torch.equal(got, want)
    assert not torch.equal(got, A.apply_attention(p, dataclasses.replace(cfg, use_rope=True),
                                                  x, pos))


def test_serving_refuses_a_pattern():
    _, cfg, leaves = _small()
    params = nest(leaves)
    with pytest.raises(NotImplementedError, match="layer pattern"):
        T.prefill(params, cfg, SINGLE_POD_PLAN, None, {"embeddings": torch.zeros(1, 8, 64)})
    with pytest.raises(NotImplementedError, match="layer pattern"):
        T.init_decode_state(cfg, SINGLE_POD_PLAN, 1, 8, "cpu")


def test_train_step_moves_every_leaf_but_the_correction_bias():
    _, cfg, leaves = _small()
    params = nest({k: v.clone() for k, v in leaves.items()})
    opt = adamw()
    step = make_train_step(cfg, SINGLE_POD_PLAN, None, opt, TrainSpec(warmup_steps=1))
    new, _, m = step(params, opt.init(params), _batch(), 1)
    for name, after in flat(new).items():
        moved = not torch.equal(after, leaves[name])
        assert moved == (not name.endswith("e_bias")), name
    assert torch.isfinite(m["loss"])


def test_moe_spans_open_once_a_layer():
    from torch.profiler import ProfilerActivity, profile
    _, cfg, leaves = _small(remat="none")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        T.loss_fn(nest(leaves), cfg, SINGLE_POD_PLAN, None, _batch())
    names = [e.name() for e in prof.profiler.kineto_results.events() if e.is_user_annotation()]
    for span in (spans.MOE_ROUTE, spans.MOE_EXPERTS, spans.MOE_SHARED, spans.MOE_COMBINE):
        assert span in spans.NAMES and names.count(span) == 2, span


def test_mfu_closed_form_counts_the_programs_matrices():
    """``hybrid_moe_train_mfu``'s active parameters a token, by layer kind,
    are the program's own matrices at the benchmark's widths: every leaf
    that multiplies activations (the experts' at top-k · held / experts
    pairs a token), and no norm, bias or per-head scalar."""
    m = _bench()["model"]
    meta, _ = abstract_params(ModelConfig(**m), SINGLE_POD_PLAN)
    layers = meta["layers"]
    mats = {"mamba": ("wz", "wx", "wb", "wc", "wdt", "wo", "conv_w", "bconv_w", "cconv_w"),
            "attn": ("wq", "wk", "wv", "wo"), "moe": ("router", "shared_w1", "shared_w2")}
    per = {kind: sum(layers[kind][k][0].numel() for k in keys) for kind, keys in mats.items()}
    experts = sum(layers["moe"][k][0].numel() for k in ("w1", "w2"))
    per["moe"] += experts / m["moe_held"] * m["moe_topk"] * m["moe_held"] / m["moe_experts"]
    want = hybrid_moe_train_mfu.layer_params(m)
    assert {"M": per["mamba"], "*": per["attn"], "E": per["moe"]} == pytest.approx(want)
    names = {k.rsplit(".", 1)[-1] for k in flat(meta) if k.startswith("layers.")}
    counted = set(mats["mamba"] + mats["attn"] + mats["moe"]) | {"w1", "w2"}
    assert names - counted == {"ln1", "conv_b", "bconv_b", "cconv_b", "a_log", "dskip",
                               "dt_bias", "norm_g", "e_bias"}


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_hybrid_flash_readers_are_the_dense_closed_forms(direction):
    """``hybrid_flash_{fwd,bwd}_roofline`` read the pattern's attention
    calls by the dense readers' closed forms at the cell's shapes, and
    nothing in a model without attention layers."""
    import importlib
    from portbench.metrics._kernels import Reading
    hybrid = importlib.import_module(f"portbench.metrics.hybrid_flash_{direction}_roofline")
    dense = importlib.import_module(f"portbench.metrics.flash_{direction}_roofline")
    m = _bench()["model"]
    traffic = json.loads((ROOT / "portbench" / "workloads" / "nemotron3-nano-30b-a3b.train_8k.json")
                         .read_text())["traffic"]
    calls = 2 * 3 * m["layer_pattern"].count("*")     # forward and recompute, 3 steps
    names = ["flash_wgmma"] if direction == "fwd" else ["bwd_pre", "bwd_kv_wgmma", "bwd_q_wgmma"]
    kernels = {n: (0.05, calls) for n in names}
    kernels["nvjet_tst_192x192"] = (1.0, 500)
    reading = lambda model: Reading(kernels, 3, 3.0, 3.0, 3.0, model, traffic)  # noqa: E731
    got = hybrid.read(reading(m))
    assert got is not None and got == dense.read(reading(dict(m, family="dense")))
    b, hq, hkv, s, d = dense.shape(reading(m))
    assert (b, hq, hkv, s, d) == (traffic["batch"], 32, 2, 8192, 128)
    assert hybrid.read(reading(dict(m, layer_pattern="MEMEME"))) is None
