"""``spaclint``: AST rules for the repo's determinism and jit-hygiene contracts.

The repo's hardest-won guarantees — bit-identical goldens, mesh-invariant
compiles, remesh-proof resume — are enforced dynamically by tests, and the
changelog shows what slips through anyway (PR 3 shipped a shared mutable
``NetSimConfig`` default that let one caller's mutation leak into every
other).  These rules catch those bug *classes* at review time, before a
golden ever diverges.  Each rule's registry entry names the contract it
protects and the incident (or near-miss) motivating it.

Usage::

    python -m repro_torch.analysis.lint src tests
    python -m repro_torch lint --format json src/repro_torch

The port's copy of the JAX package's ``analysis/lint.py``: the same rule
catalogue, messages and suppression comment, so both give the same
diagnostics on the same files (the jax rules SPAC205-SPAC207 find nothing
in torch code).

Suppression is per physical line, narrowest-scope first::

    t0 = time.time()   # spaclint: disable=SPAC203
    x = risky()        # spaclint: disable        (all rules; avoid)

Exit codes follow ``repro_torch.analysis.diagnostics``: 0 clean, 1 findings,
2 usage error.  Parse failures are findings (``SPAC200``), not crashes.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import os
import re
import sys
from typing import Dict, Iterable, List, Optional, Sequence, Set

from .diagnostics import (Diagnostic, EXIT_USAGE, exit_code, format_text,
                          to_json_payload)

__all__ = ["Rule", "RULES", "lint_source", "lint_paths", "main"]


@dataclasses.dataclass(frozen=True)
class Rule:
    code: str
    summary: str
    contract: str       # the repo guarantee this rule protects
    incident: str       # the changelog incident / near-miss motivating it


RULES: Dict[str, Rule] = {r.code: r for r in (
    Rule("SPAC200", "file does not parse",
         "everything below assumes an AST",
         "n/a — reported instead of crashing the lint run"),
    Rule("SPAC201", "mutable default argument",
         "no shared state between calls: goldens are bit-identical only if "
         "f(x) is a pure function of its arguments",
         "PR 3 shipped `cfg: NetSimConfig = NetSimConfig()`; one caller's "
         "mutation leaked into every later call and skewed p99 latencies"),
    Rule("SPAC202", "global np.random.* outside a seeded Generator",
         "all randomness flows from an explicit seed: trace generators and "
         "NSGA-II take `np.random.default_rng(seed)`, never module state",
         "a single `np.random.shuffle` in a helper would decouple goldens "
         "from their recorded seeds with no test able to say why"),
    Rule("SPAC203", "wall-clock value in a report payload outside *_time_s",
         "golden comparison strips volatile keys by the `*_time_s` naming "
         "convention (PR 4); timings under any other key diff every run",
         "launch/dryrun.py recorded `lower_s`/`compile_s` — invisible to "
         "the stripper, found by this rule's first repo-wide run"),
    Rule("SPAC204", "unordered set iteration feeding an ordered sink",
         "arrays, serialized dicts and report rows must not inherit "
         "PYTHONHASHSEED-dependent iteration order",
         "benchmarks/fig7_dse_pareto.py iterated a set comprehension of "
         "depths straight into result rows — row order varied per process"),
    Rule("SPAC205", "jitted function reads a module-level mutable global",
         "jit traces close over values at trace time: later mutation is "
         "silently ignored (stale constant) or retriggers tracing",
         "the PR 6 sharded engines were rebuilt around lru-cached pure "
         "builders precisely to avoid this class"),
    Rule("SPAC206", "unscoped enable_x64 / global jax_enable_x64 flip",
         "x64 is scoped per engine call (`with enable_x64():`, PR 4); a "
         "process-wide flip changes every other engine's dtypes mid-run",
         "surrogate quantile math needs f64 while netsim runs f32 — one "
         "global `config.update` would corrupt whichever runs second"),
    Rule("SPAC207", "jax.jit constructed inside a loop",
         "engines are jitted once at module level or inside lru-cached "
         "builders; a jit in a loop body retraces every iteration",
         "the stage-2 batched engine exists to amortise one trace over "
         "thousands of candidates — a loop-local jit undoes exactly that"),
    Rule("SPAC208", "host numpy sort inside a loop body",
         "event timelines are sorted once per trace (the `sim.timeline` "
         "memo, PR 8) and batch-wide sorts run once per call; a "
         "np.sort/argsort/lexsort in a loop body re-pays O(m log m) host "
         "work per candidate or per generation in the DSE hot path",
         "batched_netsim's shared-cap audit re-sorted the admitted "
         "departure times per candidate row — hundreds of redundant sorts "
         "of the same event batch per verify call, found while building "
         "the segmented kernel path"),
)}

_SUPPRESS_RE = re.compile(
    r"#\s*spaclint:\s*disable(?:=([A-Za-z0-9,\s]+))?")

_MUTABLE_CALLS = {"list", "dict", "set", "bytearray", "deque",
                  "defaultdict", "OrderedDict", "Counter"}
_NP_ARRAY_CALLS = {"array", "asarray", "zeros", "ones", "empty", "full",
                   "arange"}
_IMMUTABLE_CTORS = {"frozenset", "tuple", "Fraction", "Decimal"}
_SAFE_NP_RANDOM = {"default_rng", "Generator", "SeedSequence", "PCG64",
                   "MT19937", "Philox", "SFC64", "BitGenerator"}
_CLOCK_SUFFIXES = ("time.time", "time.perf_counter", "time.monotonic",
                   "time.process_time", "time.time_ns",
                   "time.perf_counter_ns", "time.monotonic_ns")
_TAINT_PRESERVING = {"round", "float", "abs", "min", "max", "sum"}
_ORDERED_SINKS = {"list", "tuple", "enumerate", "np.array", "np.asarray",
                  "numpy.array", "numpy.asarray", "jnp.array", "jnp.asarray"}


def _dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _is_clock_call(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    name = _dotted(node.func)
    if name is None:
        return False
    if name.endswith(_CLOCK_SUFFIXES) or name in {
            s.split(".", 1)[1] for s in _CLOCK_SUFFIXES}:
        return True
    parts = name.split(".")
    return parts[-1] in {"now", "utcnow"} and "datetime" in parts


def _is_set_expr(node: ast.AST) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    return (isinstance(node, ast.Call) and _dotted(node.func) == "set")


def _is_jit_call(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    name = _dotted(node.func)
    if name in {"jax.jit", "jit", "pjit", "jax.pjit"}:
        return True
    # functools.partial(jax.jit, ...) used as a decorator factory
    if name is not None and name.split(".")[-1] == "partial" and node.args:
        return _dotted(node.args[0]) in {"jax.jit", "jit"}
    return False


class _Finding:
    __slots__ = ("code", "lineno", "message", "hint")

    def __init__(self, code: str, lineno: int, message: str, hint: str = ""):
        self.code, self.lineno = code, lineno
        self.message, self.hint = message, hint


# --------------------------------------------------------------------------
# individual rule passes
# --------------------------------------------------------------------------

def _mutable_default_reason(node: ast.AST) -> Optional[str]:
    if isinstance(node, (ast.List, ast.Dict, ast.Set,
                         ast.ListComp, ast.DictComp, ast.SetComp)):
        return "a mutable literal"
    if isinstance(node, ast.Call):
        name = _dotted(node.func)
        if name is None:
            return None
        last = name.split(".")[-1]
        if last in _IMMUTABLE_CTORS:
            return None
        if last in _MUTABLE_CALLS:
            return f"a call to {last}()"
        if name.split(".")[0] in {"np", "numpy"} and last in _NP_ARRAY_CALLS:
            return f"a numpy array ({name})"
        if last[:1].isupper():
            return f"an instance of {last} (the NetSimConfig shape)"
    return None


def _check_mutable_defaults(tree: ast.AST) -> List[_Finding]:
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
            continue
        fname = getattr(node, "name", "<lambda>")
        a = node.args
        pos = a.posonlyargs + a.args
        pairs = list(zip(pos[len(pos) - len(a.defaults):], a.defaults))
        pairs += [(arg, d) for arg, d in zip(a.kwonlyargs, a.kw_defaults)
                  if d is not None]
        for arg, default in pairs:
            reason = _mutable_default_reason(default)
            if reason:
                out.append(_Finding(
                    "SPAC201", default.lineno,
                    f"default of {fname}({arg.arg}=...) is {reason}, shared "
                    f"across every call",
                    hint=f"use `{arg.arg}=None` and construct the value "
                         f"inside the function"))
    return out


def _check_global_np_random(tree: ast.AST) -> List[_Finding]:
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = _dotted(node.func)
        if name is None:
            continue
        parts = name.split(".")
        if (len(parts) >= 3 and parts[-2] == "random"
                and parts[-3] in {"np", "numpy"}
                and parts[-1] not in _SAFE_NP_RANDOM):
            out.append(_Finding(
                "SPAC202", node.lineno,
                f"{name}() draws from numpy's global RNG state",
                hint="thread a seeded np.random.default_rng(seed) Generator "
                     "through instead"))
    return out


def _check_wallclock_keys(tree: ast.AST) -> List[_Finding]:
    out = []

    def scope_body(scope) -> List[ast.stmt]:
        return scope.body

    def run_scope(body: Sequence[ast.stmt]) -> None:
        tainted: Set[str] = set()

        def is_tainted(expr: ast.AST) -> bool:
            if isinstance(expr, ast.Name):
                return expr.id in tainted
            if _is_clock_call(expr):
                return True
            if isinstance(expr, ast.Call):
                name = _dotted(expr.func) or ""
                if name.split(".")[-1] in _TAINT_PRESERVING:
                    return any(is_tainted(a) for a in expr.args)
                return False
            if isinstance(expr, ast.BinOp):
                if isinstance(expr.op, (ast.Add, ast.Sub)):
                    return is_tainted(expr.left) or is_tainted(expr.right)
                return False        # Div/Mult launder: rates, not timestamps
            if isinstance(expr, ast.UnaryOp):
                return is_tainted(expr.operand)
            if isinstance(expr, ast.IfExp):
                return is_tainted(expr.body) or is_tainted(expr.orelse)
            return False

        def check_sinks(stmt: ast.stmt) -> None:
            for node in ast.walk(stmt):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.Lambda)):
                    continue
                if isinstance(node, ast.Dict):
                    for key, value in zip(node.keys, node.values):
                        if (isinstance(key, ast.Constant)
                                and isinstance(key.value, str)
                                and not key.value.endswith("_time_s")
                                and is_tainted(value)):
                            out.append(_Finding(
                                "SPAC203", value.lineno,
                                f"wall-clock value stored under report key "
                                f"{key.value!r}",
                                hint=f"rename to {key.value + '_time_s'!r} "
                                     f"(or any *_time_s) so golden "
                                     f"comparison strips it"))
            if isinstance(stmt, ast.Assign):
                for tgt in stmt.targets:
                    if (isinstance(tgt, ast.Subscript)
                            and isinstance(tgt.slice, ast.Constant)
                            and isinstance(tgt.slice.value, str)
                            and not tgt.slice.value.endswith("_time_s")
                            and is_tainted(stmt.value)):
                        out.append(_Finding(
                            "SPAC203", stmt.lineno,
                            f"wall-clock value stored under report key "
                            f"{tgt.slice.value!r}",
                            hint=f"rename to "
                                 f"{tgt.slice.value + '_time_s'!r}"))

        def update_env(stmt: ast.stmt) -> None:
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name):
                name = stmt.targets[0].id
                (tainted.add if is_tainted(stmt.value)
                 else tainted.discard)(name)
            elif isinstance(stmt, ast.AugAssign) \
                    and isinstance(stmt.target, ast.Name) \
                    and isinstance(stmt.op, (ast.Add, ast.Sub)) \
                    and is_tainted(stmt.value):
                tainted.add(stmt.target.id)

        def walk_stmts(stmts: Sequence[ast.stmt]) -> None:
            for stmt in stmts:
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue            # own scope, handled separately
                check_sinks(stmt)
                update_env(stmt)
                for attr in ("body", "orelse", "finalbody"):
                    walk_stmts(getattr(stmt, attr, []) or [])
                for handler in getattr(stmt, "handlers", []) or []:
                    walk_stmts(handler.body)

        walk_stmts(body)

    run_scope(scope_body(tree))
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            run_scope(node.body)
    return out


def _check_set_iteration(tree: ast.AST) -> List[_Finding]:
    out = []

    def flag(node: ast.AST, sink: str) -> None:
        out.append(_Finding(
            "SPAC204", node.lineno,
            f"unordered set iterated by {sink}: order depends on "
            f"PYTHONHASHSEED",
            hint="wrap in sorted(...) to fix the order"))

    for node in ast.walk(tree):
        if isinstance(node, ast.For) and _is_set_expr(node.iter):
            flag(node.iter, "a for loop")
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                               ast.GeneratorExp)):
            for gen in node.generators:
                if _is_set_expr(gen.iter):
                    flag(gen.iter, "a comprehension")
        elif isinstance(node, ast.Call):
            name = _dotted(node.func)
            is_join = (isinstance(node.func, ast.Attribute)
                       and node.func.attr == "join")
            if (name in _ORDERED_SINKS or is_join) and node.args \
                    and _is_set_expr(node.args[0]):
                flag(node.args[0], name or "str.join")
    return out


def _check_jit_mutable_globals(tree: ast.AST) -> List[_Finding]:
    if not isinstance(tree, ast.Module):
        return []
    mutable_globals: Set[str] = set()
    for stmt in tree.body:
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name) \
                and _mutable_default_reason(stmt.value) in (
                    "a mutable literal", "a call to list()",
                    "a call to dict()", "a call to set()"):
            mutable_globals.add(stmt.targets[0].id)
    if not mutable_globals:
        return []

    jitted: List[ast.FunctionDef] = []
    fdefs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) \
                and any(_is_jit_call(d) or _dotted(d) in {"jax.jit", "jit"}
                        for d in node.decorator_list):
            jitted.append(node)
        elif isinstance(node, ast.Assign) and _is_jit_call(node.value):
            for arg in node.value.args:
                if isinstance(arg, ast.Name) and arg.id in fdefs:
                    jitted.append(fdefs[arg.id])

    out = []
    for fn in jitted:
        local = {a.arg for a in (fn.args.posonlyargs + fn.args.args
                                 + fn.args.kwonlyargs)}
        for node in ast.walk(fn):
            if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
                local.add(node.id)
        for node in ast.walk(fn):
            if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load) \
                    and node.id in mutable_globals and node.id not in local:
                out.append(_Finding(
                    "SPAC205", node.lineno,
                    f"jitted {fn.name}() reads module-level mutable "
                    f"{node.id!r}: the trace freezes its value and ignores "
                    f"later mutation",
                    hint="pass it as an argument (static_argnames for "
                         "hashables) or make the global immutable"))
    return out


def _check_x64(tree: ast.AST) -> List[_Finding]:
    with_items = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                with_items.add(id(item.context_expr))
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = _dotted(node.func) or ""
        if name.split(".")[-1] == "enable_x64" and id(node) not in with_items:
            out.append(_Finding(
                "SPAC206", node.lineno,
                "enable_x64() called outside a with-block leaks x64 into "
                "every engine that runs afterwards",
                hint="scope it: `with enable_x64(): ...`"))
        elif name.split(".")[-1] == "update" and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and node.args[0].value == "jax_enable_x64":
            out.append(_Finding(
                "SPAC206", node.lineno,
                "global jax_enable_x64 flip changes dtypes for the whole "
                "process",
                hint="use the scoped `with enable_x64():` helper from "
                     "repro.sim instead"))
    return out


def _check_jit_in_loop(tree: ast.AST) -> List[_Finding]:
    out = []

    def visit(node: ast.AST, in_loop: bool) -> None:
        if _is_jit_call(node) and in_loop \
                and not (isinstance(node, ast.Call)
                         and (_dotted(node.func) or "").split(".")[-1]
                         == "partial"):
            out.append(_Finding(
                "SPAC207", node.lineno,
                "jax.jit constructed inside a loop body retraces every "
                "iteration",
                hint="hoist the jit to module level or an lru-cached "
                     "builder keyed on the static arguments"))
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                visit(child, False)     # new scope resets loop context
            elif isinstance(child, (ast.For, ast.While)):
                for grand in ast.iter_child_nodes(child):
                    visit(grand, True)
            else:
                visit(child, in_loop)

    visit(tree, False)
    return out


_HOST_SORTS = {"sort", "argsort", "lexsort"}


def _check_sort_in_loop(tree: ast.AST) -> List[_Finding]:
    out = []

    def is_host_sort(node: ast.AST) -> bool:
        if not isinstance(node, ast.Call):
            return False
        parts = (_dotted(node.func) or "").split(".")
        return (len(parts) == 2 and parts[0] in {"np", "numpy"}
                and parts[1] in _HOST_SORTS)

    def visit(node: ast.AST, in_loop: bool) -> None:
        if in_loop and is_host_sort(node):
            name = _dotted(node.func)  # type: ignore[union-attr]
            out.append(_Finding(
                "SPAC208", node.lineno,
                f"{name}() inside a loop body re-sorts on every iteration",
                hint="hoist it: sort once per call (batch axis) or memoise "
                     "per trace via repro.sim.timeline"))
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                visit(child, False)     # new scope resets loop context
            elif isinstance(child, ast.For):
                # the iterable is evaluated once — `for k in np.argsort(x)`
                # is a single sort, not a per-iteration one
                visit(child.target, in_loop)
                visit(child.iter, in_loop)
                for stmt in child.body + child.orelse:
                    visit(stmt, True)
            elif isinstance(child, ast.While):
                for grand in ast.iter_child_nodes(child):
                    visit(grand, True)
            else:
                visit(child, in_loop)

    visit(tree, False)
    return out


_PASSES = (_check_mutable_defaults, _check_global_np_random,
           _check_wallclock_keys, _check_set_iteration,
           _check_jit_mutable_globals, _check_x64, _check_jit_in_loop,
           _check_sort_in_loop)


# --------------------------------------------------------------------------
# driver
# --------------------------------------------------------------------------

def _suppressions(source: str) -> Dict[int, Set[str]]:
    """lineno -> suppressed codes (empty set = every rule)."""
    sup: Dict[int, Set[str]] = {}
    for i, line in enumerate(source.splitlines(), start=1):
        m = _SUPPRESS_RE.search(line)
        if m:
            codes = m.group(1)
            sup[i] = ({c.strip().upper() for c in codes.split(",") if c.strip()}
                      if codes else set())
    return sup


def lint_source(source: str, filename: str = "<string>",
                select: Optional[Set[str]] = None) -> List[Diagnostic]:
    try:
        tree = ast.parse(source, filename=filename)
    except SyntaxError as e:
        return [Diagnostic("SPAC200", "error", f"does not parse: {e.msg}",
                           f"{filename}:{e.lineno or 0}")]
    sup = _suppressions(source)
    findings: List[_Finding] = []
    for check in _PASSES:
        findings.extend(check(tree))
    diags = []
    for f in sorted(findings, key=lambda f: (f.lineno, f.code)):
        if select is not None and f.code not in select:
            continue
        codes = sup.get(f.lineno)
        if codes is not None and (not codes or f.code in codes):
            continue
        diags.append(Diagnostic(f.code, "warning", f.message,
                                f"{filename}:{f.lineno}", hint=f.hint))
    return diags


def _iter_py_files(paths: Iterable[str]) -> List[str]:
    files = []
    for p in paths:
        if os.path.isfile(p):
            files.append(p)
        else:
            for root, dirs, names in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if not d.startswith((".", "__pycache__")))
                files.extend(os.path.join(root, n) for n in sorted(names)
                             if n.endswith(".py"))
    return files


def lint_paths(paths: Sequence[str],
               select: Optional[Set[str]] = None) -> List[Diagnostic]:
    diags = []
    for path in _iter_py_files(paths):
        with open(path, "r", encoding="utf-8") as fh:
            diags.extend(lint_source(fh.read(), filename=path, select=select))
    return diags


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="spaclint",
        description="static rules for the repo's determinism and "
                    "jit-hygiene contracts (SPAC2xx)")
    p.add_argument("paths", nargs="*",
                   help="files or directories to lint (default: .)")
    p.add_argument("--format", choices=("text", "json"), default="text")
    p.add_argument("--select", default=None, metavar="CODES",
                   help="comma-separated rule codes to run (default: all)")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule catalogue and exit")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_rules:
        for rule in RULES.values():
            print(f"{rule.code}  {rule.summary}")
            print(f"    contract: {rule.contract}")
            print(f"    incident: {rule.incident}")
        return 0
    select: Optional[Set[str]] = None
    if args.select:
        select = {c.strip().upper() for c in args.select.split(",")
                  if c.strip()}
        unknown = select - set(RULES)
        if unknown:
            print(f"spaclint: unknown rule code(s): {', '.join(sorted(unknown))}"
                  f" (known: {', '.join(RULES)})", file=sys.stderr)
            return EXIT_USAGE
    paths = list(args.paths) or ["."]
    missing = [p for p in paths if not os.path.exists(p)]
    if missing:
        print(f"spaclint: no such path: {', '.join(missing)}",
              file=sys.stderr)
        return EXIT_USAGE
    diags = lint_paths(paths, select=select)
    if args.format == "json":
        print(json.dumps(to_json_payload(diags), indent=2, sort_keys=True))
    else:
        print(format_text(diags, clean_message=(
            f"spaclint: {len(_iter_py_files(paths))} file(s) clean")))
    return exit_code(diags)


if __name__ == "__main__":
    raise SystemExit(main())
