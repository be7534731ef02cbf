"""Dry-run: count every (architecture × shape × mesh) cell's step on meta
tensors and price it with the roofline terms.

The port's counterpart of the JAX package's ``launch/dryrun.py``, which
lowers and compiles each cell through XLA on 512 placeholder host devices
and reads the compiler's cost and memory analyses and the HLO's
collectives.  The port has no compiler to ask; it counts, allocating
nothing and running nothing on a card:

- **The step**: ``loss_fn`` + ``backward()`` (train, with the config's
  remat), ``prefill`` or ``decode_step`` (no grad), on meta tensors from
  ``specs.input_specs`` at the reference's token counts, with
  ``attn_unroll=True`` (the reference's cost variant; its tiles, 2048 x
  4096, also cut the count's dispatches) and ``mesh=None``.  Meta tensors
  take the kernels' plain versions (``kernels.build.takes_plain``).  The
  layers are a Python loop, counted exactly at full depth, so the
  reference's L=1/L=2 extrapolation (its ``_extrapolated_cost``: XLA's cost
  analysis counts a scan body once) has no counterpart.  As there, the step
  counts as one microbatch.
- **``cost.flops``**: ``FlopCounterMode``'s total of the global step over
  ``n_chips``.  This assumes the plan splits the work perfectly: no device
  repeats another's.  **``cost["bytes accessed"]``**: every operation's
  operand and result bytes (views move none) over ``n_chips``, the unfused
  upper bound, as the reference names it.
- **``memory``**: ``argument_bytes``, ``output_bytes`` and ``alias_bytes``
  are the inputs' and outputs' per-device shards under the sanitized specs
  (the parameters and optimizer state donated on train, the decode state
  on decode).  ``temp_bytes`` is the peak of live storages (each storage
  once, however many views share it), less the arguments, in a second run
  of the step at one device's share (``device_share``): global_batch / dp
  rows, one microbatch of them on train cells, and every width the tensor
  axis splits divided by its extent.  That run counts every intermediate
  unfused, where XLA fuses some and rematerializes others (PERF.md sets
  it beside the reference's).  ``fits_16gb``
  keeps the reference's criterion, a TPU v5e's HBM.  ``compile_time_s`` is
  None (nothing compiles); ``lower_time_s`` is the two runs' wall time.
- **``collectives``**: a model of the plan, not a reading of HLO (the
  record's ``collectives_from`` says so; ``roofline.collective_bytes``
  stays the reference's HLO parser).  Per device, each op's result bytes,
  with the step's passes P (train: forward, backward and, under
  ``remat="block"``, the layers' recompute; else the forward).  Decode
  keeps the weights in place and moves activations, as the reference's
  HLO does: each product whose weight has its input dim split all-reduces
  its float32 partial sums ([rows, the output's shard], rows the batch
  over the dp axes that hold no weight shard; an expert's product its
  capacity), the vocab-split lookup likewise; plus the MoE fabric below.
  Train and prefill move the weights:

  * all-gather: each weight's FSDP shard in each pass, per layer for the
    stacked layer weights (the embedding and head in the forward and
    backward only); the MoE layer's outputs over the tensor axis;
  * reduce-scatter (train): each weight's gradient over its FSDP axes,
    then an all-reduce over any dp axis it is not sharded on;
  * all-reduce: per layer and pass, each tensor-parallel block output
    (attention, SSM mix, dense MLP) at the per-device token count T·d in
    the activation dtype, and the vocab-sharded embedding's in the forward;
  * all-to-all: the MoE fabric's dispatch and return of each chunk of its
    [E, C, d] buffer (C the per-device capacity), twice with the int8
    payload (codes, then scales), per layer and pass.
- **``roofline``**: ``derive_terms`` with ``TPU_V5E``, as in the reference.

The production meshes need 256 or 512 devices: ``lower_cell`` sets
``REPRO_TORCH_FORCE_DEVICE_COUNT`` to 512 for the duration of the call
only (``launch.mesh.forced_device_count``) and builds the mesh on the
CPU's device type.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --out experiments/dryrun
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback
import weakref
from typing import Any, Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import SHAPES, all_arch_names, get_config, shapes_for
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig, ShardingPlan
from repro_torch.models.moe import MoEOptions
from repro_torch.train.optimizer import adafactor, adamw, tree_leaves, tree_map
from .mesh import N_DEVICES, forced_device_count, make_production_mesh, plan_for_mesh
from .roofline import (TPU_V5E, derive_terms, model_flops,
                       structural_memory_bytes)
from .specs import (_extent, _sanitize_spec, abstract_params, decode_state_specs,
                    div_axes, input_specs)

__all__ = ["choose_optimizer", "choose_microbatches", "count_step", "StepCount",
           "peak_live_bytes", "device_share", "count_cell", "plan_collectives", "lower_cell", "main"]

#: what the record's ``collectives`` are
COLLECTIVES_FROM = ("plan model (train and prefill: FSDP all-gathers, gradient "
                    "reduce-scatters, tensor-parallel all-reduces; decode: weights "
                    "in place, the products' partial-sum all-reduces; MoE "
                    "all-to-alls), not HLO")
#: a product's partial sums travel in float32
_PARTIAL_BYTES = 4
#: weights of more than one dimension that no product contracts (the SSM's
#: depthwise convolution filter)
_NOT_PRODUCTS = ("conv_w",)
#: the train step's scalar metrics an output holds: loss, tokens,
#: grad_norm, lr (float32)
_METRIC_BYTES = 4 * 4


def choose_optimizer(cfg):
    """fp32 Adam fits every arch except the 1T MoE → factored states there."""
    if cfg.param_count() > 3e11:
        return adafactor(lr=1e-3), "adafactor"
    return adamw(lr=3e-4), "adamw"


def choose_microbatches(cfg, shape, mesh) -> int:
    if shape.kind != "train":
        return 1
    dp = 1
    for a in mesh.axis_names:
        if a != "model":
            dp *= mesh.shape[a]
    tokens_per_device = shape.global_batch * shape.seq_len // dp
    mb = max(1, tokens_per_device // 16384)
    while shape.global_batch % (mb * dp) and mb > 1:   # µb batch must shard
        mb -= 1
    return mb


# ------------------------------------------------------------------ counting

def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


#: an operation that returns a view without declaring one in its schema
_UNSAFE_VIEW = torch.ops.aten._unsafe_view.default


class _Bytes(TorchDispatchMode):
    """Sums every operation's operand and result bytes (a view moves none)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not (func.is_view or func is _UNSAFE_VIEW):
            self.bytes += sum(t.numel() * t.element_size()
                              for t in _tensors((args, kwargs, out)))
        return out


class _Live(TorchDispatchMode):
    """Follows the bytes of the storages the operations make: each storage
    counts once, however many views share it, from its first appearance in
    an operation's output until it is freed.  Storages of ``known`` tensors
    (the arguments) are not counted."""

    def __init__(self, known):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._known = {t.untyped_storage()._cdata for t in known}
        self._sizes: Dict[int, int] = {}

    def _free(self, key: int) -> None:
        self.live -= self._sizes.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._known or key in self._sizes:
                continue
            self._sizes[key] = st.nbytes()
            self.live += st.nbytes()
            weakref.finalize(st, self._free, key)
        self.peak = max(self.peak, self.live)
        return out


@dataclasses.dataclass(frozen=True)
class StepCount:
    flops: int                 # FlopCounterMode's total
    bytes_accessed: int        # every operation's operand and result bytes


def count_step(fn: Callable, *args) -> StepCount:
    """Run ``fn(*args)`` under ``FlopCounterMode`` and a byte counter; on
    meta tensors this allocates nothing and counts the same as on real
    ones."""
    with FlopCounterMode(display=False) as flops, _Bytes() as traffic:
        fn(*args)
    return StepCount(int(flops.get_total_flops()), int(traffic.bytes))


def peak_live_bytes(fn: Callable, *args) -> int:
    """Run ``fn(*args)`` and return the peak of the storages it made (the
    storages of ``args`` not counted)."""
    with _Live(_tensors(args)) as live:
        fn(*args)
    return int(live.peak)


def _step(cfg: ModelConfig, shape: ShapeSpec, plan: ShardingPlan, moe_opts):
    """(the counted step, the names of its arguments in ``input_specs``)."""
    if shape.kind == "train":
        def train(params, batch):
            loss, _ = T.loss_fn(params, cfg, plan, None, batch, moe_opts=moe_opts)
            loss.backward()
        return train, ("params", "batch")
    if shape.kind == "prefill":
        def prefill(params, batch):
            with torch.no_grad():
                T.prefill(params, cfg, plan, None, batch, moe_opts=moe_opts)
        return prefill, ("params", "batch")

    def decode(params, state, tok):
        with torch.no_grad():
            T.decode_step(params, cfg, plan, None, state, tok, moe_opts=moe_opts)
    return decode, ("params", "state", "tok")


def _run(counter: Callable, cfg, shape, plan, mesh, moe_opts):
    """``counter`` (``count_step`` or ``peak_live_bytes``) over the cell's
    step on meta inputs."""
    spec = input_specs(cfg, shape, plan, mesh)
    if shape.kind == "train":
        spec["params"] = tree_map(lambda p: p.detach().requires_grad_(True),
                                  spec["params"])
    fn, names = _step(cfg, shape, plan, moe_opts)
    return counter(fn, *(spec[n] for n in names))


# ----------------------------------------------------------------- the plan

def _shard_shape(struct: torch.Tensor, spec, mesh, skip=()) -> list:
    """One device's shard of ``struct`` under ``spec`` (sanitized), not
    split over the axes in ``skip``."""
    shape = []
    for dim, ax in zip(struct.shape, _sanitize_spec(struct.shape, spec, mesh)):
        axes = () if ax is None else (ax,) if isinstance(ax, str) else tuple(ax)
        shape.append(dim // _extent(tuple(a for a in axes if a not in skip), mesh))
    return shape


def _shard_bytes(struct: torch.Tensor, spec, mesh, skip=()) -> int:
    return math.prod(_shard_shape(struct, spec, mesh, skip)) * struct.element_size()


def _tree_bytes(structs, specs, mesh) -> int:
    sizes = []
    tree_map(lambda st, s: sizes.append(_shard_bytes(st, s, mesh)), structs, specs)
    return sum(sizes)


@dataclasses.dataclass(frozen=True)
class _DeviceShare(ModelConfig):
    """A config at one device's widths.  ``ssm_split`` divides the SSM's
    inner width and heads, which the config derives from ``d_model``."""
    ssm_split: int = 1

    @property
    def ssm_inner(self) -> int:
        return super().ssm_inner // self.ssm_split

    @property
    def ssm_heads(self) -> int:
        return super().ssm_heads // self.ssm_split


def device_share(cfg: ModelConfig, shape: ShapeSpec, plan: ShardingPlan, mesh,
                 rows: int):
    """(config, shape) of one device's share of a cell, for its live bytes:
    ``rows`` batch rows, and every width that the tensor axis splits, where
    the sanitized specs keep that axis, divided by its extent: the
    attention heads (query and KV, rounded up), or in decode with the KV
    cache sharded on its sequence the cache's length instead; the MLP's
    d_ff; the experts, and of each token's top-k the ceil(k/tp) one device
    serves; the SSM's inner width and heads; the vocab."""
    shape = dataclasses.replace(shape, global_batch=rows)
    tp = mesh.shape[plan.tp_axis] if plan.tensor_parallel else 1
    if tp == 1:
        return cfg, shape
    params, specs = abstract_params(cfg, plan)

    def split(*path, dim=-1) -> bool:
        st, sp = params, specs
        for key in path:
            st, sp = st[key], sp[key]
        ax = _sanitize_spec(st.shape, sp, mesh)[dim]
        return ax is not None and plan.tp_axis in ((ax,) if isinstance(ax, str) else ax)

    def up(n: int) -> int:
        return -(-n // tp)

    kw: Dict[str, Any] = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    kw["head_dim"] = cfg.hd
    if cfg.has_attention:
        if shape.kind in ("decode", "long_decode") and plan.shard_kv_seq_decode:
            _, state_spec = decode_state_specs(cfg, plan, mesh, shape)
            if state_spec["cache_k"][3] is not None:
                shape = dataclasses.replace(shape, seq_len=shape.seq_len // tp)
        elif split("layers", "attn", "wq"):
            hq = up(cfg.n_heads)
            hkv = up(cfg.n_kv_heads) if split("layers", "attn", "wk") else cfg.n_kv_heads
            if hq % hkv == 0:
                kw.update(n_heads=hq, n_kv_heads=hkv)
    if "mlp" in specs["layers"] and split("layers", "mlp", "wi"):
        kw["d_ff"] = cfg.d_ff // tp
    if cfg.is_moe and split("layers", "moe", "w1", dim=1):
        kw.update(moe_experts=cfg.moe_experts // tp, moe_topk=up(cfg.moe_topk))
    if cfg.has_ssm and split("layers", "ssm", "wz") and split("layers", "ssm", "wdt"):
        kw["ssm_split"] = tp
    if split("unembed"):
        kw["vocab"] = cfg.vocab // tp
    return _DeviceShare(**kw), shape


def _device_rows(shape: ShapeSpec, plan: ShardingPlan, mesh) -> int:
    """One device's batch rows: the batch over the dp axes where they
    divide it, else whole (replicated)."""
    dp = div_axes(shape.global_batch, tuple(plan.dp_axes), mesh)
    return shape.global_batch // (_extent(dp, mesh) if dp is not None else 1)


def plan_collectives(cfg: ModelConfig, shape: ShapeSpec, plan: ShardingPlan, mesh,
                     moe_opts: MoEOptions) -> Dict[str, Dict[str, float]]:
    """Per-device collectives of one step under ``plan`` (the model in the
    module docstring): kind -> {count, bytes}, the reference's keys."""
    stats = {k: {"count": 0, "bytes": 0.0} for k in
             ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
              "collective-permute")}

    def add(kind, count, nbytes):
        stats[kind]["count"] += int(count)
        stats[kind]["bytes"] += float(count * nbytes)

    train = shape.kind == "train"
    decode = shape.kind in ("decode", "long_decode")
    layer_passes = (3 if cfg.remat == "block" else 2) if train else 1
    head_passes = 2 if train else 1
    n_layers = cfg.n_layers
    params, specs = abstract_params(cfg, plan)
    fsdp = set(plan.fsdp_axes) if plan.fsdp_weights else set()
    tokens = _device_rows(shape, plan, mesh) * (1 if decode else shape.seq_len)
    # decode's products run on the whole batch but for the dp axes that
    # hold no weight shard
    rows = shape.global_batch // _extent(
        tuple(a for a in plan.dp_axes if a not in fsdp), mesh)
    e, k = cfg.moe_experts, cfg.moe_topk
    tp = mesh.shape[plan.tp_axis]
    t_m = -(-tokens // tp)
    cap = max(int(math.ceil(t_m * k / e * moe_opts.capacity_factor)), 1) if e else 0

    def weights(name, st, spec, per_layer: bool):
        n = n_layers if per_layer else 1
        if decode:          # the product's partial sums, where its input dim is split
            shard = _shard_shape(st, spec, mesh)[int(per_layer):]
            if len(shard) >= 2 and name not in _NOT_PRODUCTS and shard[-2] < st.shape[-2]:
                add("all-reduce", n, (cap if len(shard) == 3 else rows)
                    * math.prod(shard) // shard[-2] * _PARTIAL_BYTES)
            return
        axes = {a for ax in _sanitize_spec(st.shape, spec, mesh) if ax is not None
                for a in ((ax,) if isinstance(ax, str) else ax) if mesh.shape[a] > 1}
        shard = _shard_bytes(st, spec, mesh) // n
        if axes & fsdp:
            add("all-gather", n * (layer_passes if per_layer else head_passes),
                _shard_bytes(st, spec, mesh, skip=fsdp) // n)
            if train:
                add("reduce-scatter", n, shard)
        rest = [a for a in plan.dp_axes if a not in axes and mesh.shape[a] > 1]
        if train and rest:
            add("all-reduce", n, shard)

    def walk(name, st, spec, per_layer):
        if isinstance(st, dict):
            for key in st:
                walk(key, st[key], spec[key], per_layer)
        else:
            weights(name, st, spec, per_layer)

    for key in params:
        walk(key, params[key], specs[key], key == "layers")

    act = torch.empty((), dtype=cfg.activation_dtype).element_size()
    if plan.tensor_parallel and tp > 1 and not decode:
        per_layer = (int(cfg.has_attention) + int(cfg.has_ssm)
                     + int(bool(cfg.d_ff) and not cfg.is_moe))
        add("all-reduce", n_layers * per_layer * layer_passes, tokens * cfg.d_model * act)
        if (cfg.frontend == "tokens"        # a vocab-sharded table's lookup
                and _sanitize_spec(params["embed"].shape, specs["embed"], mesh)[0] == plan.tp):
            add("all-reduce", 1, tokens * cfg.d_model * act)
    if cfg.is_moe and tp > 1:
        chunks = max(1, min(moe_opts.a2a_chunks, cap))
        c_sub = -(-cap // chunks)
        n = n_layers * layer_passes
        if moe_opts.payload == "int8":
            add("all-to-all", 2 * chunks * n, e * c_sub * cfg.d_model)
            add("all-to-all", 2 * chunks * n, e * c_sub * (cfg.d_model // 128) * 4)
        else:
            add("all-to-all", 2 * chunks * n, e * c_sub * cfg.d_model * act)
        add("all-gather", n, t_m * tp * cfg.d_model * act)
    return stats


# --------------------------------------------------------------------- cells

def count_cell(cfg: ModelConfig, shape: ShapeSpec, mesh, plan: ShardingPlan, *,
               microbatches: int = 1, hw: Dict = TPU_V5E) -> Dict[str, Any]:
    """Count one cell on ``mesh`` (anything with ``axis_names`` and
    ``shape``) and return its record, its roofline priced with ``hw``."""
    cfg = dataclasses.replace(cfg, attn_unroll=True)
    moe_opts = MoEOptions.from_config(cfg)
    opt, opt_name = choose_optimizer(cfg)
    n_chips = math.prod(mesh.shape[a] for a in mesh.axis_names)

    t0 = time.perf_counter()
    whole = _run(count_step, cfg, shape, plan, mesh, moe_opts)
    rows = max(_device_rows(shape, plan, mesh) // microbatches, 1)
    temp = _run(peak_live_bytes, *device_share(cfg, shape, plan, mesh, rows),
                plan, mesh, moe_opts)
    t_count = time.perf_counter() - t0

    spec = input_specs(cfg, shape, plan, mesh, opt=opt)
    p_bytes = _tree_bytes(spec["params"], spec["params_spec"], mesh)
    if shape.kind == "train":
        o_bytes = _tree_bytes(spec["opt_state"], spec["opt_spec"], mesh)
        b_bytes = _tree_bytes(spec["batch"], spec["batch_spec"], mesh)
        args = p_bytes + o_bytes + b_bytes + 4                  # + the int32 step
        alias = p_bytes + o_bytes
        outs = alias + _METRIC_BYTES
    else:
        v = cfg.vocab
        dp = div_axes(shape.global_batch, tuple(plan.dp_axes), mesh)
        if shape.kind == "prefill":
            state, state_spec = decode_state_specs(cfg, plan, mesh, shape)
            logits = torch.empty((shape.global_batch, v), dtype=cfg.activation_dtype,
                                 device="meta")
            lspec = (dp, plan.tp)
            args = p_bytes + _tree_bytes(spec["batch"], spec["batch_spec"], mesh)
            alias = 0
        else:
            state, state_spec = spec["state"], spec["state_spec"]
            logits = torch.empty((shape.global_batch, 1, v), dtype=cfg.activation_dtype,
                                 device="meta")
            lspec = (dp, None, plan.tp)
            s_bytes = _tree_bytes(state, state_spec, mesh)
            args = p_bytes + s_bytes + _shard_bytes(spec["tok"], spec["tok_spec"], mesh)
            alias = s_bytes
        outs = _tree_bytes(state, state_spec, mesh) + _shard_bytes(logits, lspec, mesh)

    cost = {"flops": whole.flops / n_chips,
            "bytes accessed": whole.bytes_accessed / n_chips}
    coll = plan_collectives(cfg, shape, plan, mesh, moe_opts)
    mem_struct = structural_memory_bytes(cfg, shape, dict(mesh.shape), opt_name)
    terms = derive_terms(cost, coll, model_flops_global=model_flops(cfg, shape),
                         n_chips=n_chips, memory_bytes=mem_struct, hw=hw)
    mem_rec = {"argument_bytes": args, "output_bytes": outs,
               "temp_bytes": temp, "alias_bytes": alias,
               "generated_code_bytes": None}
    live = args + temp + outs - alias
    rec = {
        "arch": cfg.name,
        "shape": shape.name,
        "mesh": "x".join(str(mesh.shape[a]) for a in mesh.axis_names),
        "n_chips": n_chips,
        "kind": shape.kind,
        "lower_time_s": round(t_count, 1),
        "compile_time_s": None,
        "memory": mem_rec,
        "bytes_per_device_live": live,
        "fits_16gb": bool(live <= 16e9),
        "cost": cost,
        "memory_bytes_structural": mem_struct,
        "memory_bytes_unfused_upper": cost["bytes accessed"],
        "collectives": coll,
        "collectives_from": COLLECTIVES_FROM,
        "roofline": terms.as_dict(),
    }
    if shape.kind == "train":
        rec.update(optimizer=opt_name, microbatches=microbatches)
    return rec


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
               verbose: bool = True) -> Dict[str, Any]:
    """Count one cell on the production mesh (16x16, or 2x16x16 with
    ``multi_pod``); return the §Dry-run/§Roofline record."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    with forced_device_count(N_DEVICES["multi"]):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    rec = count_cell(cfg, shape, mesh, plan_for_mesh(mesh),
                     microbatches=choose_microbatches(cfg, shape, mesh))
    if verbose:
        r = rec["roofline"]
        print(f"[{arch} × {shape_name} × {rec['mesh']}] "
              f"count {rec['lower_time_s']:.0f}s | "
              f"live {rec['bytes_per_device_live']/1e9:.2f} GB/dev "
              f"(fits16GB={rec['fits_16gb']}) | "
              f"compute {r['compute_s']*1e3:.2f}ms mem {r['memory_s']*1e3:.2f}ms "
              f"coll {r['collective_s']*1e3:.2f}ms -> {r['dominant']}-bound | "
              f"useful-flops {r['useful_flops_ratio']:.2f} "
              f"roofline {r['roofline_fraction']:.2%}")
        print("  memory:", {k: v for k, v in rec["memory"].items() if v})
        print("  cost:", rec["cost"])
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    cells = []
    archs = all_arch_names() if (args.all or args.arch is None) else [args.arch]
    for a in archs:
        cfg = get_config(a)
        shapes = [s.name for s in shapes_for(cfg)] if args.shape is None else [args.shape]
        for sh in shapes:
            meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
            for mp in meshes:
                cells.append((a, sh, mp))

    failures = 0
    for a, sh, mp in cells:
        tag = f"{a}_{sh}_{'multi' if mp else 'single'}".replace(".", "_")
        out_path = os.path.join(args.out, tag + ".json")
        if os.path.exists(out_path):
            print(f"skip {tag} (exists)")
            continue
        try:
            rec = lower_cell(a, sh, multi_pod=mp)
            with open(out_path, "w") as f:
                json.dump(rec, f, indent=1)
        except Exception:  # noqa: BLE001 — a failing cell is a bug to record
            failures += 1
            print(f"FAIL {tag}")
            traceback.print_exc()
            with open(out_path + ".fail", "w") as f:
                f.write(traceback.format_exc())
    print(f"done: {len(cells)} cells, {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
