"""Structured diagnostics shared by ``check`` and ``lint`` (the port's copy
of the JAX package's ``analysis/diagnostics.py``).

One record type serves both front-ends: spec-level findings (``SPAC1xx``,
``repro_torch.analysis.check``) and source-level lint findings (``SPAC2xx``,
``repro_torch.analysis.lint``) render through the same text/JSON formatting and
the same exit-code convention:

  * ``0`` — clean (only ``info`` diagnostics, if any)
  * ``1`` — findings (at least one ``warning`` or ``error``)
  * ``2`` — usage / input error (bad path, malformed JSON, unknown scenario)

Severities order ``error > warning > info``; ``info`` never fails a run —
it carries context like co-design space sizes and feasible fractions.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List

__all__ = ["Diagnostic", "SEVERITIES", "worst_severity", "exit_code",
           "format_text", "to_json_payload",
           "EXIT_CLEAN", "EXIT_FINDINGS", "EXIT_USAGE"]

#: ranked weakest-first so ``max(..., key=SEVERITIES.index)`` picks the worst
SEVERITIES = ("info", "warning", "error")

EXIT_CLEAN = 0
EXIT_FINDINGS = 1
EXIT_USAGE = 2


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One finding: a stable code, a severity, where, what, and how to fix.

    ``location`` is a spec path (``protocol.dst``, ``sla.p99_latency_ns``)
    for check diagnostics and ``file.py:line`` for lint diagnostics —
    always a plain string so the record serializes untouched.
    """

    code: str           # "SPAC101" / "SPAC204" / ...
    severity: str       # one of SEVERITIES
    message: str
    location: str
    hint: str = ""

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"unknown severity {self.severity!r}; "
                             f"known: {SEVERITIES}")

    def to_dict(self) -> Dict[str, Any]:
        d = {"code": self.code, "severity": self.severity,
             "message": self.message, "location": self.location}
        if self.hint:
            d["hint"] = self.hint
        return d

    def format(self) -> str:
        line = f"{self.location}: {self.severity} {self.code} {self.message}"
        if self.hint:
            line += f"\n    hint: {self.hint}"
        return line


def worst_severity(diags: Iterable[Diagnostic]) -> str:
    worst = "info"
    for d in diags:
        if SEVERITIES.index(d.severity) > SEVERITIES.index(worst):
            worst = d.severity
    return worst


def exit_code(diags: Iterable[Diagnostic]) -> int:
    """The 0/1 half of the convention (2 is raised before any Diagnostic
    exists — it means the input never became checkable)."""
    return EXIT_CLEAN if worst_severity(diags) == "info" else EXIT_FINDINGS


def format_text(diags: List[Diagnostic], *, clean_message: str = "clean") -> str:
    if not diags:
        return clean_message
    return "\n".join(d.format() for d in diags)


def to_json_payload(diags: List[Diagnostic]) -> Dict[str, Any]:
    return {"diagnostics": [d.to_dict() for d in diags],
            "worst_severity": worst_severity(diags) if diags else None,
            "exit_code": exit_code(diags)}
