"""Where the JAX package's per-device dry-run FLOP differ from the port's.

The reference's ``cost.flops`` is XLA's cost analysis of the per-device
module; the port's (``repro_torch.launch.dryrun``) is the global step's
matrix products over the device count.  This script reads the reference's
per-device HLO: it compiles the reference's cost variant of a cell
(``_lower_one`` at 1 and 2 layers, unrolled, as its ``_extrapolated_cost``
does) on 512 forced host devices, sums every ``dot``'s FLOP by class, and
extrapolates each class to the config's depth:

  ssd      the SSD scan's chunk products (``ssd_chunked``'s einsums)
  bc_proj  the B/C projections (``bsd,dn->bsn``: N is not split)
  head     a vocab head whose vocab dim is whole on the device (a vocab
           the model axis does not divide: ``_sanitize_spec`` replicates it)
  rest     every other product

It prints one JSON line: the classes, their total, that total with the
three classes split over the model axis (``split``), the reference's
extrapolated ``cost.flops`` (dots and elementwise work), the port's
``cost.flops`` for the same cell, and the SSD product's rows per device
against B/dp x heads (all heads on every device where they are equal).

    PYTHONPATH=src python tests/torch_dryrun_hlo.py mamba2-780m prefill_32k

(~1 min a cell on a CPU; the port's count is part of it.)
"""

import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import collections  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import re  # noqa: E402

import jax  # noqa: E402
import jax.experimental  # noqa: E402

# jax 0.9 dropped jax.experimental.enable_x64, which the reference's batched
# engines import; alias it to the scoped config switch before importing them
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = lambda: jax.enable_x64(True)

from repro.configs import SHAPES, get_config  # noqa: E402
from repro.launch.dryrun import _lower_one, choose_optimizer  # noqa: E402
from repro.launch.mesh import make_production_mesh, plan_for_mesh  # noqa: E402
from repro.models.moe import MoEOptions  # noqa: E402

_DEF = re.compile(r"\s*(?:ROOT )?%([\w.\-]+) = \w+\[([\d,]*)\]")
_DOT = re.compile(r"\s*(?:ROOT )?%[\w.\-]+ = \w+\[([\d,]*)\]\S* dot\(%([\w.\-]+), %([\w.\-]+)\)")


def _dims(text):
    return [int(x) for x in text.split(",") if x]


def dot_classes(hlo: str, vocab: int):
    """class -> FLOP of the per-device module's dots, and the SSD
    products' leading (rows) dim."""
    shapes = {m.group(1): _dims(m.group(2)) for m in map(_DEF.match, hlo.splitlines()) if m}
    out, rows = collections.Counter(), set()
    for line in hlo.splitlines():
        m = _DOT.match(line)
        if not m:
            continue
        res, lhs, rhs = _dims(m.group(1)), shapes[m.group(2)], shapes[m.group(3)]
        k = 1
        for d in re.search(r"lhs_contracting_dims=\{([\d,]*)\}", line).group(1).split(","):
            if d:
                k *= lhs[int(d)]
        n = 1
        for r in res:
            n *= r
        op = re.search(r'op_name="([^"]*)"', line).group(1)
        if "ssd_chunked" in op:
            cls = "ssd"
            rows.add(lhs[0])
        elif "bsd,dn->bsn" in op:
            cls = "bc_proj"
        elif "bsd,dv->bsv" in op and vocab in lhs + rhs + res:
            cls = "head"
        else:
            cls = "rest"
        out[cls] += 2 * n * k
    return out, rows


def main(arch: str, shape_name: str) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh()
    plan = plan_for_mesh(mesh)
    opt = choose_optimizer(cfg)[0]
    per, cost, rows = [], [], set()
    for layers in (1, 2):
        cfg_l = dataclasses.replace(cfg, n_layers=layers, scan_layers=False,
                                    attn_unroll=True)
        compiled = _lower_one(cfg_l, shape, plan, mesh, opt,
                              MoEOptions.from_config(cfg_l), 1).compile()
        c = compiled.cost_analysis()
        cost.append(float((c[0] if isinstance(c, (list, tuple)) else c)["flops"]))
        classes, r = dot_classes(compiled.as_text(), cfg.vocab)
        per.append(classes)
        rows |= r
    depth = cfg.n_layers - 1
    ext = {k: per[0][k] + depth * (per[1][k] - per[0][k]) for k in set(per[0]) | set(per[1])}
    tp = mesh.shape["model"]
    total = sum(ext.values())
    replicated = sum(v for k, v in ext.items() if k != "rest")
    dp = mesh.shape["data"]
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src"))
    from repro_torch.launch.dryrun import lower_cell
    port = lower_cell(arch, shape_name, verbose=False)["cost"]["flops"]
    return {"arch": arch, "shape": shape_name, "dot_flops": ext, "dot_total": total,
            "split": total - replicated * (tp - 1) / tp,
            "ref_cost_flops": cost[0] + depth * (cost[1] - cost[0]),
            "port_cost_flops": port, "ssd_rows_per_device": sorted(rows),
            "batch_per_dp_x_heads": max(shape.global_batch // dp, 1) * cfg.ssm_heads
            if cfg.has_ssm else None}


if __name__ == "__main__":
    print(json.dumps(main(sys.argv[1], sys.argv[2])))
