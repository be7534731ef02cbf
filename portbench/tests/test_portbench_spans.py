"""``portbench/spans.py`` on a hand-built list of profiler events: a forward
kernel, a backward kernel reached through its node's sequence number (an op
that makes no node takes that number before the node's maker does, and the
node's own event carries it too), a recompute kernel, a copy under
``train.lr`` and the idle gap after it, an unspanned kernel, one with no
launch, and the blocking calls; and ``Trace``'s readings unmoved by the
program's annotations."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from portbench import spans
from portbench.trace import WINDOW, Trace

MAIN, WORKER = 1, 2


class Ev:
    """The parts of a ``torch`` ``_KinetoEvent`` that the readers call."""

    def __init__(self, name, start, end, *, cuda=False, ann=False, corr=0, tid=MAIN,
                 seq=-1, fwd_tid=0):
        self._name, self._start, self._end = name, start, end
        self.cuda, self.ann, self.corr = cuda, ann, corr
        self.tid, self.seq, self.fwd_tid = tid, seq, fwd_tid

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def end_ns(self):
        return self._end

    def duration_ns(self):
        return self._end - self._start

    def device_type(self):
        return "DeviceType.CUDA" if self.cuda else "DeviceType.CPU"

    def is_user_annotation(self):
        return self.ann

    def correlation_id(self):
        return self.corr

    def start_thread_id(self):
        return self.tid

    def sequence_nr(self):
        return self.seq

    def fwd_thread_id(self):
        return self.fwd_tid


def span(name, start, end, tid=MAIN):
    return Ev(f"repro_torch.{name}", start, end, ann=True, tid=tid)


def kernel(name, start, end, corr):
    return Ev(name, start, end, cuda=True, corr=corr)


def launch(corr, at, tid=MAIN, name="cudaLaunchKernel"):
    return Ev(name, at, at + 3, corr=corr, tid=tid)


#: the program's annotations: the spans on the host and their copies on the
#: device's timeline
PROGRAM = [
    span("train.step", 10, 900), span("train.forward", 20, 300),
    span("model.block", 30, 100), span("train.backward", 300, 600),
    span("model.block.recompute", 320, 360, tid=WORKER), span("train.lr", 600, 800),
    Ev("repro_torch.model.block", 100, 150, cuda=True, ann=True),
    Ev("repro_torch.train.backward", 400, 650, cuda=True, ann=True),
]

OPERATIONS = [
    Ev(WINDOW, 0, 1000, ann=True),
    Ev("aten::to", 22, 28, seq=5), Ev("aten::mul", 40, 50, seq=5),
    launch(1, 45), kernel("k_fwd", 100, 150, 1),
    Ev(spans.NODE + "MulBackward0", 310, 400, tid=WORKER, seq=5, fwd_tid=MAIN),
    Ev("MulBackward0", 315, 395, tid=WORKER, seq=5, fwd_tid=MAIN),
    launch(3, 330, tid=WORKER), kernel("k_rec", 400, 450, 3),
    launch(2, 370, tid=WORKER), kernel("k_bwd", 460, 650, 2),
    Ev("MulBackward0", 500, 510, seq=5, fwd_tid=MAIN),
    Ev("aten::to", 605, 640, seq=9),
    launch(4, 610, name="cudaMemcpyAsync"), kernel("Memcpy HtoD", 700, 705, 4),
    launch(5, 620, name="cudaStreamSynchronize"),
    launch(6, 950), kernel("k_none", 960, 980, 6),
    launch(7, 955, name="cudaStreamSynchronize"),
    kernel("k_lost", 980, 985, 99),
]


def prof(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: list(events))))


def test_charges_of_each_kind():
    ch = spans.charge(prof(OPERATIONS + PROGRAM))
    assert ch.spans == pytest.approx({
        "model.block/fwd": 50e-9, "model.block.recompute/recompute": 50e-9,
        "model.block/bwd": 190e-9, "train.lr/fwd": 5e-9, "(none)/fwd": 20e-9,
        "(no launch)": 5e-9})
    assert ch.nodes == pytest.approx({"MulBackward0": 190e-9})
    assert ch.device_s == pytest.approx(sum(ch.spans.values()))
    assert ch.bwd_s == pytest.approx(240e-9) and ch.bwd_layers_s == pytest.approx(240e-9)
    assert ch.idle_by_span == pytest.approx({
        "(none)": 100e-9 + 15e-9, "train.forward": 250e-9, "train.backward": 10e-9,
        "train.lr": 50e-9 + 255e-9})
    assert ch.syncs == {"train.lr": 1} and ch.steps == 1
    m = spans.metrics(ch)
    assert m == pytest.approx({
        "block_fwd_ms_per_step": 50e-6, "block_recompute_ms_per_step": 50e-6,
        "block_bwd_ms_per_step": 190e-6, "optimizer_ms_per_step": 5e-6,
        "host_syncs_per_step": 1.0})


def test_a_program_without_spans_reads_nothing():
    ch = spans.charge(prof(OPERATIONS))
    assert ch.steps == 0 and spans.metrics(ch) == {}
    assert ch.device_s == pytest.approx(sum(ch.spans.values()))


def test_trace_readings_ignore_the_program_annotations():
    bare, marked = Trace(prof(OPERATIONS)), Trace(prof(OPERATIONS + PROGRAM))
    assert marked.kernels() == bare.kernels()
    assert marked.busy_s == bare.busy_s
    assert marked.idle_gaps() == bare.idle_gaps()
    assert sum(s for s, _ in marked.kernels().values()) == pytest.approx(
        spans.charge(prof(OPERATIONS + PROGRAM), marked).device_s)


@pytest.mark.parametrize("intervals, times, want", [
    ([(0, 10, "a"), (2, 5, "b")], [1, 3, 5, 10], ["a", "b", "a", None]),
    ([(0, 4, "a"), (6, 9, "b"), (6, 7, "c")], [5, 6, 8, 4], [None, "c", "b", None]),
])
def test_innermost(intervals, times, want):
    assert spans.innermost(intervals, times) == want
