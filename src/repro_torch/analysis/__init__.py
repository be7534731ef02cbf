"""Static analysis for the port: spec diagnostics, lint rules, retrace guard.

The port's copy of the JAX package's ``analysis``:

* ``repro_torch.analysis.check`` — ``python -m repro_torch check``:
  spec-level ``SPAC1xx`` diagnostics (addressability, SLA satisfiability,
  budget vs the minimal resource plan, dead co-design genes,
  feasible-fraction estimates) with no trace build and no kernel launch.
* ``repro_torch.analysis.lint`` — ``python -m repro_torch lint``: AST
  ``SPAC2xx`` rules for the determinism and jit-hygiene contracts.
* ``repro_torch.analysis.retrace`` — call-key guard asserting the batched
  engines see one argument shape per (shape, static arguments), as jit
  would compile them.

This ``__init__`` stays light on purpose: the sim engine modules import
``retrace`` at load time while ``check`` imports the port's ``core`` and
``sim`` — so ``check``/``lint`` resolve lazily to keep the graph acyclic.
"""

from .diagnostics import (Diagnostic, SEVERITIES, EXIT_CLEAN, EXIT_FINDINGS,
                          EXIT_USAGE, worst_severity, exit_code, format_text,
                          to_json_payload)
from .retrace import (track, tracked_names, compile_counts, RetraceError,
                      RetraceGuard, retrace_guard)

__all__ = [
    "Diagnostic", "SEVERITIES", "EXIT_CLEAN", "EXIT_FINDINGS", "EXIT_USAGE",
    "worst_severity", "exit_code", "format_text", "to_json_payload",
    "track", "tracked_names", "compile_counts", "RetraceError",
    "RetraceGuard", "retrace_guard",
    "check_scenario", "lint_source", "lint_paths",
]


def __getattr__(name):
    if name == "check_scenario":
        from .check import check_scenario
        return check_scenario
    if name in ("lint_source", "lint_paths"):
        from . import lint
        return getattr(lint, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
