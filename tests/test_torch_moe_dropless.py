"""The dropless expert layer's row moves (``repro_torch.kernels.moe_dropless``).

Contract, on the CPU with the plain versions (no JAX):

- ``dispatch_ref`` puts each held pair's token in its row of the buffer and
  zero in every row from ``count`` on; ``combine_ref`` is each token's sum
  over its held pairs of gate · row, in float32, whatever the rows past
  ``count`` hold (NaN included), and so are their gradients: nothing from
  past ``count`` reaches a token, a gate or a row;
- the wrappers refuse what the kernels do not take before any launch.

On the card (``cuda``-marked; ``JAX_PLATFORMS=cpu PYTHONPATH=src python3 -m
pytest -q -m cuda tests/test_torch_moe_dropless.py``): the kernels against
the plain versions at Nemotron-3-Nano's cell shape (T 32,768, k 6, d 2,688,
8 of 128 experts held) and a small ragged one, forward and gradients, with
each kernel's counter; the rows past ``count`` left as they were; two calls
bitwise equal.
"""

from __future__ import annotations

import pytest
import torch

from repro_torch.kernels import moe_dropless
from repro_torch.kernels.moe_dropless import kernel as mk
from repro_torch.kernels.moe_dropless import ref

BF16, F32 = torch.bfloat16, torch.float32


def _layout(t, k, experts, held, dev="cpu", seed=0):
    """(order, pos, count, gates) for a random routing of t tokens to k of
    ``experts`` experts, the first ``held`` held."""
    g = torch.Generator(dev).manual_seed(seed)
    scores = torch.rand((t, experts), generator=g, device=dev)
    experts_of = torch.sort(scores, dim=-1, descending=True, stable=True).indices[:, :k]
    local = experts_of.reshape(-1)
    key = torch.where(local < held, local, held)
    order = torch.argsort(key, stable=True)
    count = (key < held).sum().to(torch.int32).reshape(1)
    pos = torch.empty_like(order).scatter_(0, order, torch.arange(t * k, device=dev)).view(t, k)
    gates = torch.rand((t, k), generator=g, device=dev)
    return order, pos, count, gates


@pytest.mark.parametrize("first", [0, 5, 12])
def test_sort_pairs_puts_each_held_experts_pairs_in_order(first):
    """``moe.sort_pairs``: rows by held expert, each expert's pairs in pair
    order, the rest after ``count``; ``pos`` inverts ``order``; the ends."""
    from repro_torch.models.moe import sort_pairs
    t, k, e, held = 50, 3, 16, 4
    g = torch.Generator().manual_seed(first)
    experts = torch.rand((t, e), generator=g).topk(k, dim=-1).indices
    order, pos, counts, offs, count = sort_pairs(experts, first, held)
    flat = experts.reshape(-1).tolist()
    want = [p for x in range(first, first + held) for p in range(t * k) if flat[p] == x]
    assert order[:len(want)].tolist() == want
    assert sorted(order[len(want):].tolist()) == [p for p in range(t * k)
                                                  if not first <= flat[p] < first + held]
    assert torch.equal(order[pos.reshape(-1)], torch.arange(t * k))
    assert counts.tolist() == [flat.count(x) for x in range(first, first + held)]
    assert offs.dtype == count.dtype == torch.int32
    assert offs.tolist() == torch.cumsum(counts, 0).tolist() and count.tolist() == [len(want)]


def test_chip_smoke_form_is_the_cells_expert_layer():
    """chip_smoke.py times the row moves and the glue's Nemotron forms at
    the benchmark cell's shapes."""
    import importlib.util
    import json
    import pathlib
    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    m = json.loads((root / "portbench/configs/nemotron3-nano-30b-a3b.json").read_text())["model"]
    tr = json.loads((root / "portbench/workloads/nemotron3-nano-30b-a3b.train_8k.json")
                    .read_text())["traffic"]
    form, t, k, e, d, held = cs.MOE_DROPLESS_FORM
    assert t == tr["batch"] * tr["seq_len"]
    assert (k, e, d, held, 0) == (m["moe_topk"], m["moe_experts"], m["d_model"],
                                  m["moe_held"], m["moe_held_first"])
    for name in cs.MOE_DROPLESS_KERNELS:
        assert cs.KERNELS[name]["main"][0] == form, name
    for b, s, h, p, _, _, _, groups in cs.GLUE_BIAS_GROUP_FORMS.values():
        assert (b, s) == (tr["batch"], tr["seq_len"])
        assert (h, p) in ((m["ssm_nheads"], m["ssm_headdim"]), (m["ssm_groups"], m["ssm_state"]))


def _rel(a, b) -> float:
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
def test_plain_moves_are_the_loops_they_state(dtype):
    t, k, d = 40, 3, 16
    order, pos, count, gates = _layout(t, k, 8, 3, seed=1)
    xs = torch.randn((t, d)).to(dtype)
    rows = moe_dropless.dispatch(xs, order, pos, count)
    n = int(count)
    for r in range(t * k):
        want = xs[int(order[r]) // k] if r < n else torch.zeros(d, dtype=dtype)
        assert torch.equal(rows[r], want), r
    y_rows = torch.randn((t * k, d)).to(dtype)
    y_rows[n:] = float("nan")                        # past count: never read
    out = moe_dropless.combine(y_rows, gates, order, pos, count)
    for tok in range(t):
        acc = torch.zeros(d, dtype=F32)
        for j in range(k):
            p = int(pos[tok, j])
            if p < n:
                acc = acc + y_rows[p].float() * gates[tok, j]
        assert torch.allclose(out[tok].float(), acc.to(dtype).float(), rtol=1e-6, atol=0), tok


def test_plain_gradients_never_read_past_count():
    t, k, d = 32, 4, 8
    order, pos, count, gates = _layout(t, k, 8, 2, seed=2)
    n = int(count)
    xs = torch.randn((t, d), requires_grad=True)
    y_rows = torch.randn((t * k, d))
    y_rows[n:] = float("nan")
    y_rows.requires_grad_(True)
    g = gates.clone().requires_grad_(True)
    rows = moe_dropless.dispatch(xs, order, pos, count)
    out = moe_dropless.combine(y_rows, g, order, pos, count)
    drows = torch.randn_like(rows)
    drows[n:] = float("nan")
    dxs, = torch.autograd.grad(rows, [xs], drows)
    dy, dg = torch.autograd.grad(out, [y_rows, g], torch.randn_like(out))
    assert torch.isfinite(dxs).all() and torch.isfinite(dg).all()
    assert torch.isfinite(dy[:n]).all() and not dy[n:].any()
    held = pos < n
    assert not dg[~held].any()


def _bad_calls():
    order, pos, count, gates = _layout(16, 2, 4, 2)
    xs = torch.randn((16, 8))
    return [("cpu_gather", lambda: mk.gather(xs, order, count, 32), "CUDA"),
            ("cpu_sum", lambda: mk.token_sum(xs.repeat(2, 1), pos, count), "CUDA"),
            ("float16", lambda: mk.gather(xs.half(), order, count, 32), "dtype"),
            ("count_dtype", lambda: mk.gather(xs, order, count.long(), 32), "int32"),
            ("grad", lambda: mk.gather(xs.requires_grad_(True), order, count, 32), "gradient")]


@pytest.mark.parametrize("case", range(len(_bad_calls())), ids=[c[0] for c in _bad_calls()])
def test_wrappers_refuse_what_the_kernels_do_not_take(case):
    name, call, message = _bad_calls()[case]
    before = (mk.GATHER_LAUNCHES, mk.TOKEN_SUM_LAUNCHES, mk.PAIR_DOT_LAUNCHES)
    with pytest.raises((ValueError, RuntimeError), match=message):
        call()
    assert (mk.GATHER_LAUNCHES, mk.TOKEN_SUM_LAUNCHES, mk.PAIR_DOT_LAUNCHES) == before, name


# --------------------------------------------------------------------------
# the kernels on the card
# --------------------------------------------------------------------------

#: (T, k, experts, held, d): Nemotron-3-Nano's cell (4 x 8,192 tokens, top-6
#: of 128, 8 held, d 2,688), a small ragged one, every pair held
CARD_FORMS = ((32768, 6, 128, 8, 2688), (1000, 3, 16, 5, 64), (64, 2, 4, 4, 32))


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _counters():
    return mk.GATHER_LAUNCHES, mk.TOKEN_SUM_LAUNCHES, mk.PAIR_DOT_LAUNCHES


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("form", CARD_FORMS, ids=lambda f: "T{}k{}E{}held{}d{}".format(*f))
def test_cuda_moves_vs_plain(form, dtype):
    """Forwards: the gather bitwise, the weighted sum within an ulp of the
    activation dtype (the same float32 terms, summed in another order);
    gradients within 1e-5 (float32) / 1e-2 (bf16) of autograd of the plain
    versions in norm."""
    dev = _cuda()
    t, k, e, held, d = form
    order, pos, count, gates = _layout(t, k, e, held, dev, seed=t)
    n = int(count)
    g = torch.Generator(dev).manual_seed(7)
    xs = torch.randn((t, d), generator=g, device=dev).to(dtype)
    y_rows = torch.randn((t * k, d), generator=g, device=dev).to(dtype)
    drows = torch.randn((t * k, d), generator=g, device=dev).to(dtype)
    dout = torch.randn((t, d), generator=g, device=dev).to(dtype)
    tol = 1e-2 if dtype == BF16 else 1e-5
    c0 = _counters()

    def run(fn, leaves):
        leaves = [x.detach().clone().requires_grad_(x.is_floating_point()) for x in leaves]
        a, b = leaves[0], leaves[1]
        rows = fn[0](a, order, pos, count)
        out = fn[1](b, leaves[2], order, pos, count)
        grads = torch.autograd.grad((rows, out), [a, b, leaves[2]], (drows, dout))
        return rows, out, grads

    rows, out, grads = run((moe_dropless.dispatch, moe_dropless.combine), (xs, y_rows, gates))
    torch.cuda.synchronize()
    assert _counters() == (c0[0] + 2, c0[1] + 2, c0[2] + 1)
    p_rows, p_out, p_grads = run((ref.dispatch_ref, ref.combine_ref), (xs, y_rows, gates))
    assert torch.equal(rows[:n], p_rows[:n])
    assert _rel(out, p_out) <= (4e-3 if dtype == BF16 else 1e-6)
    dxs, dy, dg = grads
    assert _rel(dxs, p_grads[0]) <= tol and _rel(dg, p_grads[2]) <= tol
    assert _rel(dy[:n], p_grads[1][:n]) <= tol


@pytest.mark.cuda
def test_cuda_moves_leave_the_rows_past_count_and_repeat_bitwise():
    dev = _cuda()
    t, k, e, held, d = CARD_FORMS[0]
    order, pos, count, gates = _layout(t, k, e, held, dev)
    n = int(count)
    xs = torch.randn((t, d), device=dev).to(BF16)
    a = mk.gather(xs, order // k, count, t * k)
    b = mk.gather(xs, order // k, count, t * k)
    assert torch.equal(a[:n], b[:n])
    y_rows = torch.randn((t * k, d), device=dev).to(BF16)
    one = mk.token_sum(y_rows, pos, count, gates)
    y_rows[n:] = float("nan")                          # never read
    two = mk.token_sum(y_rows, pos, count, gates)
    assert torch.equal(one, two) and torch.isfinite(two.float()).all()
    dout = torch.randn((t, d), device=dev).to(BF16)
    assert torch.equal(mk.pair_dot(dout, y_rows, pos, count),
                       mk.pair_dot(dout, y_rows, pos, count))
