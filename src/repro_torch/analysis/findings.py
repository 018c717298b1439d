"""Structured findings of the static plan checks (a copy of the
reference's ``analysis/findings.py``).

Every lint rule reports through one shape: a :class:`Finding` with a
stable rule id (``plan.dense_fallthrough``, ...), a severity, the location
it blames (a plan row path), a message and a fix hint. Findings serialize
to plain JSON; ``gate()`` turns a batch of them into a process exit code
(errors fail, warnings do not). Rule ids are what ``waive`` drops.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence

ERROR = "error"
WARNING = "warning"
INFO = "info"
_SEVERITIES = (ERROR, WARNING, INFO)


@dataclass(frozen=True)
class Finding:
    """One verifier finding. ``where`` is the blamed location: a plan
    row path for plan lints, the jitted entry name for HLO lints, the
    entry + step for the retrace sentinel."""
    rule: str
    severity: str
    where: str
    message: str
    hint: str = ""
    data: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.severity not in _SEVERITIES:
            raise ValueError(f"severity must be one of {_SEVERITIES}, "
                             f"got {self.severity!r}")

    def to_json(self) -> Dict[str, Any]:
        return {"rule": self.rule, "severity": self.severity,
                "where": self.where, "message": self.message,
                "hint": self.hint, "data": dict(self.data)}

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "Finding":
        return cls(rule=d["rule"], severity=d["severity"],
                   where=d["where"], message=d["message"],
                   hint=d.get("hint", ""), data=dict(d.get("data", {})))


def waive(findings: Iterable[Finding],
          rules: Optional[Sequence[str]] = None) -> List[Finding]:
    """Drop findings whose rule id is in ``rules`` (the waiver list)."""
    waived = set(rules or ())
    return [f for f in findings if f.rule not in waived]


def errors(findings: Iterable[Finding]) -> List[Finding]:
    return [f for f in findings if f.severity == ERROR]


def gate(findings: Iterable[Finding]) -> int:
    """Exit code for a batch of findings: 1 if any error survives."""
    return 1 if errors(findings) else 0


def findings_to_json(findings: Iterable[Finding]) -> List[Dict[str, Any]]:
    return [f.to_json() for f in findings]


_SEV_ORDER = {ERROR: 0, WARNING: 1, INFO: 2}


def format_findings(findings: Sequence[Finding],
                    title: str = "") -> str:
    """Human-readable report: one block per finding, errors first."""
    lines: List[str] = []
    if title:
        lines.append(title)
    if not findings:
        lines.append("  no findings")
        return "\n".join(lines)
    ordered = sorted(findings,
                     key=lambda f: (_SEV_ORDER[f.severity], f.rule, f.where))
    for f in ordered:
        lines.append(f"  [{f.severity.upper():<7}] {f.rule}  @ {f.where}")
        lines.append(f"      {f.message}")
        if f.hint:
            lines.append(f"      fix: {f.hint}")
    n_err = len(errors(ordered))
    lines.append(f"  {len(ordered)} finding(s), {n_err} error(s)")
    return "\n".join(lines)
