"""The port's command line (``python -m repro_torch``): the JAX package's
``spac`` front door, with the same subcommands, flags and exit codes.

    python -m repro_torch list                          # registry scenarios
    python -m repro_torch show hft                      # dump a scenario as JSON
    python -m repro_torch check hft                     # static diagnostics (SPAC1xx)
    python -m repro_torch check my_scenario.json --format json
    python -m repro_torch lint src/repro_torch tests    # determinism lint (SPAC2xx)
    python -m repro_torch ingest capture.csv -o capture.npz   # pcap/CSV -> Trace
    python -m repro_torch ingest lan.pcap --stage "filter:min_payload=64" \
        --stage "incast:dst=0,n_senders=6,n_packets=128" --seed 7
    python -m repro_torch run hft --sla-p99-ns 5000     # one scenario, with overrides
    python -m repro_torch run my_scenario.json --out report.json
    python -m repro_torch run hft --search nsga2 --generations 10 --search-seed 0
    python -m repro_torch run hft --search nsga2 --co-design
    python -m repro_torch run hft --search nsga2 --checkpoint-dir ckpt && \
        python -m repro_torch run hft --search nsga2 --checkpoint-dir ckpt --resume
    python -m repro_torch run fattree_dc                # a fat-tree fabric
    python -m repro_torch run hft --use-kernel off      # the ring-scan engine
    python -m repro_torch sweep hft underwater industry # campaign over registry names
    python -m repro_torch sweep --config campaign.json  # campaign from a config file
    python -m repro_torch serve hft datacenter --repeat 4   # continuous-batched DSE service
    python -m repro_torch serve --requests reqs.json --out served.json --stats

Every subcommand that runs takes ``--device`` (default ``cuda``: the port
runs on the card and raises without one; ``--device cpu`` runs the kernels'
plain PyTorch versions).  ``--devices N`` above 1 raises: a mesh is not
ported yet (ROADMAP queue 1: mesh).

Serve request schema (JSON): a list of entries; each entry is a registry
name, a scenario dict, or ``{"base"|"scenario": ..., "seed": ..., "repeat":
N, ...overrides}`` — the scenario part resolves exactly like a campaign
entry, ``seed`` overrides the trace generator seed, ``repeat`` enqueues the
request N times (cache-hit fodder).

Campaign config schema (JSON): either a plain list of entries or
``{"name": ..., "scenarios": [...]}``; each entry is a registry name, a full
scenario dict (``Scenario.to_dict()`` shape), or ``{"base": "<registry
name>", ...overrides}`` where the overrides deep-merge into the base spec.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, Mapping, Optional, Sequence

__all__ = ["main", "build_parser", "resolve_entry", "load_campaign_config"]

PROG = "python -m repro_torch"
#: exit code for input that never became runnable (malformed capture/stage)
EXIT_USAGE = 2


# --------------------------------------------------------------------------
# config resolution
# --------------------------------------------------------------------------

def _deep_merge(base: Mapping[str, Any], over: Mapping[str, Any]) -> Dict[str, Any]:
    out = dict(base)
    for k, v in over.items():
        if k in out and isinstance(out[k], Mapping) and isinstance(v, Mapping):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def resolve_entry(entry):
    """Campaign entry → ``Scenario`` (name | full dict | base + overrides)."""
    from .registry import registry
    from .scenario import Scenario
    if isinstance(entry, str):
        return registry[entry]
    if not isinstance(entry, Mapping):
        raise ValueError(f"bad campaign entry {entry!r}")
    if "base" in entry:
        base = registry[entry["base"]].to_dict()
        over = {k: v for k, v in entry.items() if k != "base"}
        # an override that names a trace *source* (generator or saved file)
        # replaces the base trace wholesale — merging would leave the base's
        # generator next to an override path and fail exactly-one validation
        t = over.get("trace")
        if isinstance(t, Mapping) and ("path" in t or "generator" in t):
            base.pop("trace", None)
        return Scenario.from_dict(_deep_merge(base, over))
    return Scenario.from_dict(entry)


def load_campaign_config(cfg) -> Dict[str, Any]:
    """Normalise a campaign config to {"name", "scenarios": [Scenario, ...]}."""
    if isinstance(cfg, list):
        cfg = {"scenarios": cfg}
    entries = cfg.get("scenarios", [])
    if not entries:
        raise ValueError("campaign config has no scenarios")
    return {"name": cfg.get("name", "campaign"),
            "scenarios": [resolve_entry(e) for e in entries]}


def _parse_kv(pairs: Optional[Sequence[str]]) -> Dict[str, Any]:
    """``key=value`` CLI pairs; values parse as JSON literals, else strings."""
    out: Dict[str, Any] = {}
    for p in pairs or ():
        if "=" not in p:
            raise SystemExit(f"expected key=value, got {p!r}")
        k, v = p.split("=", 1)
        try:
            out[k] = json.loads(v)
        except json.JSONDecodeError:
            out[k] = v
    return out


def _load_scenario(target: str):
    """Registry name, or path to a Scenario JSON file (or to a report that
    ``run --out`` wrote, such as ``tests/golden/comm_small.json``: its
    scenario reruns)."""
    from .registry import registry
    from .scenario import Scenario
    if target in registry:
        return registry[target]
    if target.endswith(".json"):
        try:
            with open(target) as f:
                doc = json.load(f)
            if isinstance(doc, dict) and "scenario" in doc and "pareto" in doc:
                doc = doc["scenario"]
            return Scenario.from_dict(doc)
        except (OSError, json.JSONDecodeError) as e:
            raise SystemExit(
                f"cannot load scenario file {target!r}: {e}") from e
        except (KeyError, TypeError, ValueError) as e:
            raise SystemExit(f"bad scenario spec in {target!r}: {e}") from e
    raise SystemExit(
        f"unknown scenario {target!r} (not in registry, not a .json path); "
        f"known: {', '.join(registry.names())}")


def _search_override(scenario, args):
    """CLI search flags -> SearchSpec (or the ``override`` keep-sentinel)."""
    import dataclasses
    from .scenario import _KEEP
    from repro_torch.core.search import SearchSpec
    updates = {k: v for k, v in {
        "population": getattr(args, "population", None),
        "generations": getattr(args, "generations", None),
        "seed": getattr(args, "search_seed", None),
        "mutation_rate": getattr(args, "mutation_rate", None),
        "crossover_rate": getattr(args, "crossover_rate", None),
        "max_evaluations": getattr(args, "max_evals", None),
        "checkpoint_dir": getattr(args, "checkpoint_dir", None),
    }.items() if v is not None}
    algo = getattr(args, "search", None)
    if algo is None and not updates:
        return _KEEP
    if algo is None and scenario.search is None:
        raise SystemExit(
            "--generations/--population/... need --search ALGO (or a "
            "scenario that already carries a search spec)")
    base = scenario.search or SearchSpec()
    if algo is not None:
        updates["algorithm"] = algo
    return dataclasses.replace(base, **updates)


def _apply_overrides(scenario, args):
    trace_params = _parse_kv(getattr(args, "trace", None))
    if getattr(args, "seed", None) is not None:
        trace_params.setdefault("seed", args.seed)
    if getattr(args, "duration_s", None) is not None:
        trace_params.setdefault("duration_s", args.duration_s)
    if trace_params and scenario.domain != "switch":
        raise SystemExit("trace overrides only apply to switch-domain scenarios")
    budget_limits = _parse_kv(getattr(args, "budget", None))
    search = _search_override(scenario, args)
    co_design = getattr(args, "co_design", None)
    try:
        out = scenario.override(
            search=search,
            sla_p99_latency_ns=args.sla_p99_ns,
            sla_drop_rate=args.sla_drop_rate,
            sla_min_throughput_gbps=args.sla_min_gbps,
            trace_params=trace_params or None,
            budget_limits={k: float(v) for k, v in budget_limits.items()} or None,
            back_annotation=args.back_annotation,
            delta=args.delta,
            top_k=args.top_k,
            verify_engine=args.verify_engine,
            use_kernel=getattr(args, "use_kernel", None),
            flit_bits=args.flit_bits,
            co_design=co_design,
        )
    except ValueError as e:
        # user-input problems (unwidenable builder, un-narrowable ranged
        # spec, bad trace override) exit cleanly like every other CLI error
        raise SystemExit(str(e)) from e
    if out.co_design:
        # whether co-design came from --co-design or from the scenario file,
        # the joint space needs a search engine and a searchable protocol —
        # fail here, cleanly, not as a build_problem traceback mid-run
        if out.search is None:
            raise SystemExit(
                f"scenario {out.name!r} has co-design on but no search "
                "spec: add --search nsga2 (the joint protocol x "
                "architecture space is not enumerable)")
        try:
            out.protocol.space()
        except ValueError as e:
            raise SystemExit(str(e)) from e
    return out


def _add_override_flags(p: argparse.ArgumentParser) -> None:
    from repro_torch.core.dse import USE_KERNEL_MODES, VERIFY_ENGINES
    g = p.add_argument_group("scenario overrides")
    g.add_argument("--sla-p99-ns", type=float, default=None,
                   help="p99 latency SLA in ns")
    g.add_argument("--sla-drop-rate", type=float, default=None,
                   help="target tail drop rate epsilon")
    g.add_argument("--sla-min-gbps", type=float, default=None,
                   help="minimum sustained throughput (Gbps)")
    g.add_argument("--seed", type=int, default=None, help="trace generator seed")
    g.add_argument("--duration-s", type=float, default=None,
                   help="trace duration in seconds (generators that take it)")
    g.add_argument("--trace", action="append", metavar="KEY=VAL",
                   help="extra trace generator param (repeatable)")
    g.add_argument("--budget", action="append", metavar="KEY=VAL",
                   help="resource budget limit override (repeatable)")
    g.add_argument("--flit-bits", type=int, default=None)
    g.add_argument("--top-k", type=int, default=None,
                   help="stage-3 exploration width")
    g.add_argument("--delta", type=float, default=None,
                   help="stage-1 timing slack")
    g.add_argument("--back-annotation", action=argparse.BooleanOptionalAction,
                   default=None, help="eta from cycle sim (slow) vs analytic")
    g.add_argument("--verify-engine", choices=VERIFY_ENGINES,
                   default=None,
                   help="stage-4 fidelity rung: batched netsim (default), "
                        "cycle-accurate datapath for every survivor, or "
                        "auto (netsim front + cycle-sim champion)")
    g.add_argument("--use-kernel", choices=USE_KERNEL_MODES, default=None,
                   help="segmented netsim kernels for the batched stage-2/4 "
                        "engines: auto (kernel when available, bit-exact "
                        "oracle fallback), on, or off (legacy scans)")
    from repro_torch.core.search import SEARCH_ALGORITHMS
    gs = p.add_argument_group(
        "search engine (generational NSGA-II instead of exhaustive "
        "stage-1/2 enumeration)")
    gs.add_argument("--search", choices=SEARCH_ALGORITHMS, default=None,
                    help="enable the generational engine over the "
                         "problem's parameterized design space")
    gs.add_argument("--generations", type=int, default=None,
                    help="generation budget")
    gs.add_argument("--population", type=int, default=None,
                    help="population size per generation")
    gs.add_argument("--search-seed", type=int, default=None,
                    help="engine RNG seed (bit-reproducible)")
    gs.add_argument("--mutation-rate", type=float, default=None)
    gs.add_argument("--crossover-rate", type=float, default=None)
    gs.add_argument("--max-evals", type=int, default=None,
                    help="hard cap on evaluated genomes (an upper bound on "
                         "surrogate rows: pruned/duplicate genomes are "
                         "answered from cache)")
    gs.add_argument("--checkpoint-dir", default=None,
                    help="save search state here every generation "
                         "(campaigns nest per-scenario subdirectories)")
    gs.add_argument("--resume", action="store_true",
                    help="resume a checkpointed search from its "
                         "checkpoint directory")
    gs.add_argument("--co-design", action=argparse.BooleanOptionalAction,
                    default=None, dest="co_design",
                    help="search the protocol layout jointly with the "
                         "architecture: per-field width genes join the "
                         "genome (point protocol specs widen to the default "
                         "co-design menus; needs --search)")
    p.add_argument("--device", default="cuda",
                   help="where the DSE runs: cuda (default; the hand-written "
                        "kernels, raises without a card) or cpu (their plain "
                        "PyTorch versions)")
    gm = p.add_argument_group(
        "device mesh (not ported yet: any N > 1 raises)")
    gm.add_argument("--devices", type=int, default=None, metavar="N",
                    help="shard the batched stage-2/stage-4 scans over N "
                         "devices (default 1 = the serial path; an execution "
                         "knob, never part of the scenario/report, so "
                         "checkpoints resume across device counts)")
    gm.add_argument("--scenario-devices", type=int, default=None, metavar="M",
                    help="second, data-parallel mesh axis campaigns use to "
                         "spread scenario groups (total devices = N*M)")


def _mesh_from_args(args):
    """--devices/--scenario-devices -> Optional[MeshSpec] (None = serial)."""
    devices = getattr(args, "devices", None)
    scenario_axis = getattr(args, "scenario_devices", None)
    if devices is None and scenario_axis is None:
        return None
    from .scenario import MeshSpec
    try:
        spec = MeshSpec(devices=devices or 1, scenario_axis=scenario_axis or 1)
    except ValueError as e:
        raise SystemExit(str(e)) from e
    return None if spec.is_single() else spec


def _split_stage_params(s: str):
    """Split ``key=val,key=val`` on top-level commas only, so JSON list/dict
    values (``ports=[0,1]``, ``mapping={"3": 0}``) pass through intact."""
    out, cur, depth = [], [], 0
    for ch in s:
        if ch in "[{(":
            depth += 1
        elif ch in "]})":
            depth -= 1
        if ch == "," and depth == 0:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        out.append("".join(cur))
    return out


def _parse_stage(spec: str):
    """CLI ``--stage kind:key=val,...`` -> (kind, params).  Values parse as
    JSON literals, else strings; syntax errors raise ``ValueError`` so
    ``ingest`` can exit with the usage code (2)."""
    kind, _, rest = spec.partition(":")
    if not kind:
        raise ValueError(f"--stage {spec!r}: empty stage kind")
    params: Dict[str, Any] = {}
    for item in _split_stage_params(rest):
        if not item.strip():
            continue
        if "=" not in item:
            raise ValueError(
                f"--stage {spec!r}: expected key=value, got {item!r}")
        k, v = item.split("=", 1)
        try:
            params[k.strip()] = json.loads(v)
        except json.JSONDecodeError:
            params[k.strip()] = v
    return kind, params


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=PROG,
        description="SPAC on PyTorch/CUDA: protocol-adaptive switch "
                    "customization — declarative scenarios from protocol to "
                    "Pareto front.")
    sub = p.add_subparsers(dest="cmd", required=True)

    lp = sub.add_parser("list", help="list registry scenarios")
    lp.add_argument("--json", action="store_true", help="emit JSON")

    sp = sub.add_parser("show", help="dump a scenario spec as JSON")
    sp.add_argument("scenario", help="registry name or .json path")

    cp = sub.add_parser(
        "check",
        help="static spec diagnostics (SPAC1xx): addressability, SLA "
             "satisfiability, budget vs the minimal plan, dead co-design "
             "genes — no trace, no kernel; exits 0 clean / 1 findings / "
             "2 usage")
    cp.add_argument("scenarios", nargs="+",
                    help="registry names or .json paths")
    cp.add_argument("--format", choices=("text", "json"), default="text")

    tp = sub.add_parser(
        "lint",
        help="determinism/jit-hygiene lint (SPAC2xx) — same engine as "
             "python -m repro_torch.analysis.lint")
    tp.add_argument("paths", nargs="*",
                    help="files or directories to lint (default: .)")
    tp.add_argument("--format", choices=("text", "json"), default="text")
    tp.add_argument("--select", default=None, metavar="CODES",
                    help="comma-separated rule codes to run")
    tp.add_argument("--list-rules", action="store_true",
                    help="print the rule catalogue and exit")

    ip = sub.add_parser(
        "ingest",
        help="pcap/CSV capture -> Trace .npz, through a declarative stage "
             "pipeline (filter/remap_ports/rescale_time/clip) plus "
             "generative stressors (incast/zipf_drift/diurnal); exits 0 "
             "ok / 2 malformed input")
    ip.add_argument("capture", help="input .pcap/.cap or .csv path")
    ip.add_argument("-o", "--out", default=None, metavar="FILE",
                    help="output .npz path (default: capture stem + .npz)")
    ip.add_argument("--name", default=None,
                    help="trace name recorded in the .npz (default: stem)")
    ip.add_argument("--n-ports", type=int, default=None,
                    help="declared endpoint count (default: inferred from "
                         "the max src/dst id seen)")
    ip.add_argument("--link-gbps", type=float, default=100.0,
                    help="link rate the trace models (default 100)")
    ip.add_argument("--stage", action="append", metavar="KIND[:K=V,...]",
                    help="pipeline stage, repeatable and order-preserving; "
                         "values are JSON literals, e.g. "
                         "--stage 'clip:max_packets=1000' "
                         "--stage 'incast:dst=0,n_senders=4,n_packets=64'")
    ip.add_argument("--seed", type=int, default=0,
                    help="pipeline seed; stage i draws an independent "
                         "stream from (seed, i), so results are "
                         "bit-reproducible")

    rp = sub.add_parser("run", help="run one scenario")
    rp.add_argument("scenario", help="registry name or .json path")
    _add_override_flags(rp)
    rp.add_argument("--out", default=None, metavar="FILE",
                    help="write the structured report as JSON")
    rp.add_argument("--save-config", default=None, metavar="FILE",
                    help="write the (post-override) scenario spec as JSON")
    rp.add_argument("-v", "--verbose", action="store_true")

    wp = sub.add_parser("sweep", help="run a multi-scenario campaign")
    wp.add_argument("scenarios", nargs="*",
                    help="registry names (overrides below apply to each)")
    wp.add_argument("--config", default=None, metavar="FILE",
                    help="campaign JSON (see module docstring for the schema)")
    _add_override_flags(wp)
    wp.add_argument("--out", default=None, metavar="FILE",
                    help="write the campaign report as JSON")
    wp.add_argument("-v", "--verbose", action="store_true")

    vp = sub.add_parser(
        "serve",
        help="continuously-batched DSE service: scenario requests share "
             "fixed-width stage-2/stage-4 calls and content-addressed "
             "trace/problem/report caches — repeat traffic is answered "
             "without touching a simulator")
    vp.add_argument("scenarios", nargs="*",
                    help="registry names or .json paths to enqueue")
    vp.add_argument("--requests", default=None, metavar="FILE",
                    help="request list JSON (see module docstring)")
    vp.add_argument("--repeat", type=int, default=1, metavar="N",
                    help="enqueue each positional scenario N times")
    vp.add_argument("--seed", type=int, action="append", default=None,
                    metavar="S", help="trace seed(s); repeatable — each "
                    "positional scenario is enqueued once per seed")
    vp.add_argument("--slots", type=int, default=4,
                    help="concurrent requests multiplexed per tick")
    vp.add_argument("--batch-width", type=int, default=64,
                    help="fixed stage-2 surrogate chunk width (rows)")
    vp.add_argument("--verify-width", type=int, default=16,
                    help="fixed stage-4 netsim chunk width (rows)")
    vp.add_argument("--devices", type=int, default=None, metavar="N",
                    help="shard every chunk over N devices (not ported "
                         "yet: any N > 1 raises)")
    vp.add_argument("--device", default="cuda",
                    help="where the service runs: cuda (default; the "
                         "hand-written kernels, raises without a card) or "
                         "cpu (their plain PyTorch versions)")
    vp.add_argument("--out", default=None, metavar="FILE",
                    help="write per-request reports + engine stats as JSON")
    vp.add_argument("--stats", action="store_true",
                    help="print cache/chunk counters after draining")
    return p


# --------------------------------------------------------------------------
# subcommands
# --------------------------------------------------------------------------

def _cmd_list(args) -> int:
    from .registry import registry
    if args.json:
        print(json.dumps([s.to_dict() for s in registry], indent=2))
        return 0
    print(f"{'name':16s} {'domain':7s} {'trace':14s} {'sla p99':>10s} "
          f"{'drop':>8s}  notes")
    for name in registry.names():
        s = registry[name]
        trace = ("routing" if s.domain == "comm"
                 else s.trace.generator or "file")
        p99 = ("-" if s.sla.p99_latency_ns == float("inf")
               else f"{s.sla.p99_latency_ns:.0f}ns")
        print(f"{name:16s} {s.domain:7s} {trace:14s} {p99:>10s} "
              f"{s.sla.drop_rate:>8.0e}  {s.notes[:60]}")
    return 0


def _cmd_show(args) -> int:
    print(_load_scenario(args.scenario).to_json())
    return 0


def _cmd_check(args) -> int:
    import dataclasses
    from repro_torch.analysis.check import check_scenario
    from repro_torch.analysis.diagnostics import (exit_code, format_text,
                                                  to_json_payload)
    diags = []
    for target in args.scenarios:
        try:
            scenario = _load_scenario(target)
        except SystemExit as e:
            # input that never became checkable is a usage error (2), kept
            # distinct from findings (1) so CI can tell the two apart
            print(f"{PROG} check: {e}", file=sys.stderr)
            return EXIT_USAGE
        diags.extend(dataclasses.replace(d, location=f"{target}:{d.location}")
                     for d in check_scenario(scenario))
    if args.format == "json":
        print(json.dumps(to_json_payload(diags), indent=2, sort_keys=True))
    else:
        print(format_text(diags, clean_message=(
            f"{PROG} check: {len(args.scenarios)} scenario(s) clean")))
    return exit_code(diags)


def _cmd_lint(args) -> int:
    from repro_torch.analysis.lint import main as lint_main
    argv = []
    if args.list_rules:
        argv.append("--list-rules")
    if args.select:
        argv += ["--select", args.select]
    argv += ["--format", args.format]
    return lint_main(argv + list(args.paths))


def _cmd_run(args) -> int:
    from .runner import run_scenario
    scenario = _apply_overrides(_load_scenario(args.scenario), args)
    if args.save_config:
        scenario.save(args.save_config)
        print(f"wrote scenario spec to {args.save_config}")
    report = run_scenario(scenario, verbose=args.verbose, resume=args.resume,
                          mesh=_mesh_from_args(args), device=args.device)
    print(report.summary())
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report.to_dict(), f, indent=2)
        print(f"wrote report to {args.out}")
    return 0 if report.best is not None else 1


def _cmd_ingest(args) -> int:
    from repro_torch.traces.ingest import Pipeline, ingest
    try:
        pipe = Pipeline(seed=args.seed)
        for spec in args.stage or ():
            kind, params = _parse_stage(spec)
            pipe = pipe.then(kind, **params)
        tr = ingest(args.capture,
                    pipeline=pipe if pipe.stages else None,
                    name=args.name, n_ports=args.n_ports,
                    link_gbps=args.link_gbps)
    except (ValueError, OSError) as e:
        # malformed capture/stage input is a usage error (2), as in the
        # reference's ``spac ingest``
        print(f"{PROG} ingest: {e}", file=sys.stderr)
        return EXIT_USAGE
    out = args.out or (os.path.splitext(args.capture)[0] + ".npz")
    tr.save(out)
    dur_us = ((tr.time_s[-1] - tr.time_s[0]) * 1e6) if len(tr.time_s) else 0.0
    print(f"wrote {out}: {len(tr.time_s)} packets, {tr.n_ports} ports, "
          f"{dur_us:.1f} us span, {tr.link_gbps:g} Gbps")
    return 0


def _cmd_sweep(args) -> int:
    from .runner import run_campaign
    if args.config:
        with open(args.config) as f:
            cfg = load_campaign_config(json.load(f))
        name, scenarios = cfg["name"], cfg["scenarios"]
    elif args.scenarios:
        name = "campaign"
        scenarios = [_load_scenario(t) for t in args.scenarios]
    else:
        raise SystemExit("sweep needs scenario names or --config FILE")
    scenarios = [_apply_overrides(s, args) for s in scenarios]
    report = run_campaign(scenarios, name=name, verbose=args.verbose,
                          resume=args.resume, mesh=_mesh_from_args(args),
                          device=args.device)
    print(report.summary())
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report.to_dict(), f, indent=2)
        print(f"wrote campaign report to {args.out}")
    return 0 if all(r.best is not None for r in report.reports) else 1


def _serve_requests(args):
    """CLI inputs → [(Scenario, seed|None)] in submission order."""
    pairs = []
    seeds = args.seed if args.seed else [None]
    for target in args.scenarios:
        for s in seeds:
            pairs.extend([(_load_scenario(target), s)] * max(args.repeat, 1))
    if args.requests:
        with open(args.requests) as f:
            entries = json.load(f)
        if not isinstance(entries, list):
            raise SystemExit(f"{args.requests}: expected a JSON list")
        for entry in entries:
            seed, repeat = None, 1
            if isinstance(entry, Mapping):
                entry = dict(entry)
                seed = entry.pop("seed", None)
                repeat = int(entry.pop("repeat", 1))
                inner = entry.pop("scenario", None)
                if inner is not None:
                    # {"scenario": name-or-dict, ...overrides}: the inner
                    # spec is the base the remaining keys merge into
                    if isinstance(inner, str):
                        entry["base"] = inner
                    else:
                        entry = _deep_merge(inner, entry)
            spec = resolve_entry(entry)
            pairs.extend([(spec, seed)] * max(repeat, 1))
    if not pairs:
        raise SystemExit("serve needs scenario names or --requests FILE")
    return pairs


def _cmd_serve(args) -> int:
    from .service import DSEServeEngine
    pairs = _serve_requests(args)
    eng = DSEServeEngine(slots=args.slots, batch_width=args.batch_width,
                         verify_width=args.verify_width,
                         mesh=_mesh_from_args(args), device=args.device)
    for scenario, seed in pairs:
        eng.submit(scenario, seed=seed)
    finished = eng.run_until_drained()
    stats = eng.stats()
    for req in finished:
        mark = "cached" if req.cached else f"{req.wall_time_s:6.2f}s"
        tail = (f"error: {req.error}" if req.error
                else f"best={req.report.get('best')}")
        print(f"  {req.rid:>6s} {req.scenario.name:16s} [{mark}] {tail}")
    n_err = sum(1 for r in finished if r.error)
    print(f"served {len(finished)} request(s), {n_err} error(s); "
          f"report cache {stats['report_hits']} hit / "
          f"{stats['report_misses']} miss, "
          f"stage2 {stats['stage2_rows']} rows / "
          f"{stats['stage2_chunks']} chunks "
          f"({stats['stage2_cands_per_sec']:.0f} cand/s)")
    if args.stats:
        print(json.dumps({k: v for k, v in stats.items()},
                         indent=2, sort_keys=True))
    if args.out:
        payload = {"requests": [dict(r.summary_dict(), report=r.report)
                                for r in finished],
                   "stats": stats}
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=2)
        print(f"wrote serve report to {args.out}")
    return 0 if n_err == 0 else 1


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return {"list": _cmd_list, "show": _cmd_show, "check": _cmd_check,
            "lint": _cmd_lint, "ingest": _cmd_ingest, "run": _cmd_run,
            "sweep": _cmd_sweep, "serve": _cmd_serve}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
