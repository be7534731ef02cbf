"""The training step's spans (``repro_torch.spans``) under ``torch.profiler``.

Contract, on the CPU at smoke widths (mamba2-780m's SSD block and
llama3.2-1b's dense block, 3 layers, remat by block, AdamW):

- one step opens ``train.step``, ``train.clip``, ``train.lr`` and
  ``train.optimizer`` once, ``train.forward``, ``train.backward`` and
  ``model.loss`` once a microbatch, and ``model.block`` and
  ``model.block.recompute`` once a layer and microbatch;
- the blocks and the loss lie inside ``train.forward``, the recomputed
  blocks inside ``train.backward``, both inside ``train.step``;
- 95 % or more of the backward's operator time (the operators each
  ``evaluate_function`` node runs) belongs to nodes whose forward operator,
  found by the node's sequence number and forward thread, lies inside
  ``model.block`` or ``model.loss``;
- without a profiler no ``record_function`` is made;
- a step's parameters and loss are bitwise the same with the profiler on.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.configs import get_smoke
from repro_torch.models import SINGLE_POD_PLAN
from repro_torch.models import transformer as T
from repro_torch.train import TrainSpec, adamw, make_train_step
from repro_torch.train.optimizer import tree_leaves

ARCHS = ("mamba2-780m", "llama3.2-1b")
LAYERS = 3
NODE = "autograd::engine::evaluate_function: "


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(arch: str, microbatches: int = 1):
    cfg = dataclasses.replace(get_smoke(arch), remat="block", n_layers=LAYERS)
    params = T.init_params(torch.Generator().manual_seed(0), cfg, SINGLE_POD_PLAN)
    opt = adamw()
    step = make_train_step(cfg, SINGLE_POD_PLAN, None, opt,
                           TrainSpec(microbatches=microbatches, warmup_steps=1))
    gen = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab, (2, 64), generator=gen)
             for k in ("tokens", "labels")}
    return params, opt.init(params), step, batch


def _profiled_step(arch: str, microbatches: int = 1):
    params, state, step, batch = _setup(arch, microbatches)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(params, state, batch, 1)
    return list(prof.profiler.kineto_results.events())


def _spans(events):
    """(start, end, name) of each program span, in order of start."""
    return sorted((e.start_ns(), e.end_ns(), e.name()) for e in events
                  if e.is_user_annotation() and e.name() in spans.NAMES)


def _innermost(intervals, t):
    """The payload of the latest-begun interval holding ``t``, or None."""
    best = None
    for start, end, payload in intervals:
        if start <= t < end and (best is None or start >= best[0]):
            best = (start, payload)
    return best and best[1]


@pytest.mark.parametrize("arch, microbatches", [(a, 1) for a in ARCHS] + [(ARCHS[0], 2)])
def test_each_span_opens_as_often_as_its_place_says(arch, microbatches):
    got = {}
    for _, _, name in _spans(_profiled_step(arch, microbatches)):
        got[name] = got.get(name, 0) + 1
    m = microbatches
    assert got == {spans.STEP: 1, spans.FORWARD: m, spans.BACKWARD: m, spans.LOSS: m,
                   spans.BLOCK: LAYERS * m, spans.RECOMPUTE: LAYERS * m,
                   spans.CLIP: 1, spans.LR: 1, spans.OPTIMIZER: 1}


@pytest.mark.parametrize("arch", ARCHS)
def test_spans_nest_inside_their_phase(arch):
    marks = _spans(_profiled_step(arch))
    within = {spans.BLOCK: spans.FORWARD, spans.LOSS: spans.FORWARD,
              spans.RECOMPUTE: spans.BACKWARD, spans.FORWARD: spans.STEP,
              spans.BACKWARD: spans.STEP, spans.CLIP: spans.STEP, spans.LR: spans.STEP,
              spans.OPTIMIZER: spans.STEP}
    for start, end, name in marks:
        if name in within:
            outer = [(s, e) for s, e, n in marks if n == within[name]]
            assert any(s <= start and end <= e for s, e in outer), name


@pytest.mark.parametrize("arch", ARCHS)
def test_backward_links_to_the_blocks_and_the_loss(arch):
    events = _profiled_step(arch)
    marks = _spans(events)
    nodes = [(e.start_ns(), e.end_ns(), (e.sequence_nr(), e.fwd_thread_id()))
             for e in events if e.name().startswith(NODE)]
    ops = sorted((e.start_ns(), e.end_ns(), e) for e in events
                 if e.name().startswith("aten::") and not e.is_user_annotation())
    # the last operator to record a sequence number made its node
    maker = {}
    for start, _, e in ops:
        if e.sequence_nr() >= 0 and not e.fwd_thread_id():
            maker[(e.sequence_nr(), e.start_thread_id())] = start
    (b0, b1, _), = [m for m in marks if m[2] == spans.BACKWARD]
    linked = total = 0
    last_end = -1
    for start, end, e in ops:
        if not b0 <= start < b1 or start < last_end:
            continue                                  # outside, or inside another op
        last_end = end
        where = _innermost(marks + nodes, start)
        if not isinstance(where, tuple):
            continue                                  # the recompute's forward operators
        total += end - start
        fwd_at = maker.get(where)
        if fwd_at is not None and _innermost(marks, fwd_at) in (spans.BLOCK, spans.LOSS):
            linked += end - start
    assert total > 0 and linked / total >= 0.95, linked / total


def test_no_record_function_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) was made")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    params, state, step, batch = _setup(ARCHS[0])
    step(params, state, batch, 1)
    with pytest.raises(AssertionError, match="was made"):
        with profile(activities=[ProfilerActivity.CPU]):
            step(params, state, batch, 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_profiler_leaves_a_step_bitwise(arch):
    params, state, step, batch = _setup(arch)
    plain, _, m_plain = step(params, state, batch, 1)
    with profile(activities=[ProfilerActivity.CPU]):
        traced, _, m_traced = step(params, state, batch, 1)
    assert torch.equal(m_plain["loss"], m_traced["loss"])
    for a, b in zip(tree_leaves(plain), tree_leaves(traced)):
        assert torch.equal(a, b)
