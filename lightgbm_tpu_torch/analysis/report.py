"""The trace doctor's finding and report model (a copy of
``lightgbm_tpu/analysis/report.py``: the same classes, the same
rendering, so that a finding reads the same in both packages).

Every pass (the op lint, the collective lint, the capture guard, the
doctor's targets) reports through one :class:`Finding` (rule id,
severity, entry-point label, op path, byte estimate, message),
collected per linted program into a :class:`TraceReport`. The CI gate
(``scripts/torch_lint_traces.py``) and the tests fail on any
``error``-severity finding that no allowlist entry waives. The rules
and what each catches in the port are listed in ``analysis/__init__.py``.

Waivers: an allowlist entry is ``(rule, pattern)``, ``fnmatch``
patterns matched against ``"label:op_path"``. A waived finding is kept
(severity ``info``, ``waived=True``) so reports stay auditable, but it
no longer fails the gate.
"""

from __future__ import annotations

import dataclasses
from fnmatch import fnmatch
from typing import Iterable, List, Sequence, Tuple

__all__ = ["Finding", "TraceReport", "SEVERITIES", "merge_errors"]

SEVERITIES = ("error", "warn", "info")


@dataclasses.dataclass
class Finding:
    """One rule violation in one linted program."""
    rule: str                 # TDnnn
    severity: str             # error | warn | info
    label: str                # entry-point label (e.g. fused_step/plain)
    op_path: str              # op name / jaxpr var / const index
    message: str
    nbytes: int = 0           # byte estimate where meaningful
    waived: bool = False

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"unknown severity {self.severity!r}")

    def key(self) -> str:
        return f"{self.label}:{self.op_path}"

    def render(self) -> str:
        size = f" [{self.nbytes / 2**20:.1f} MiB]" if self.nbytes else ""
        waived = " (waived)" if self.waived else ""
        return (f"{self.rule} {self.severity:<5} {self.label}: "
                f"{self.message}{size} @ {self.op_path}{waived}")


@dataclasses.dataclass
class TraceReport:
    """Findings of one linted program (or one guard scope)."""
    label: str
    findings: List[Finding] = dataclasses.field(default_factory=list)

    def add(self, rule: str, severity: str, op_path: str, message: str,
            nbytes: int = 0) -> Finding:
        f = Finding(rule=rule, severity=severity, label=self.label,
                    op_path=op_path, message=message, nbytes=nbytes)
        self.findings.append(f)
        return f

    def apply_allowlist(
            self, allow: Sequence[Tuple[str, str]]) -> "TraceReport":
        """Downgrade findings matching ``(rule, pattern)`` entries to
        waived info-severity. Patterns fnmatch against
        ``"label:op_path"`` (so ``("TD101", "fused_step/*")`` waives a
        whole entry point and ``("TD103", "*iota*")`` one op)."""
        for f in self.findings:
            for rule, pat in allow:
                if f.rule == rule and (fnmatch(f.key(), pat)
                                       or fnmatch(f.op_path, pat)
                                       or fnmatch(f.label, pat)):
                    f.waived = True
                    f.severity = "info"
                    break
        return self

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings
                if f.severity == "error" and not f.waived]

    @property
    def ok(self) -> bool:
        return not self.errors

    def render(self, verbose: bool = False) -> str:
        shown = self.findings if verbose else [
            f for f in self.findings if f.severity != "info" or f.waived]
        lines = [f"{self.label}: "
                 f"{len(self.errors)} error(s), "
                 f"{len(self.findings)} finding(s)"]
        lines += ["  " + f.render() for f in shown]
        return "\n".join(lines)


def merge_errors(reports: Iterable[TraceReport]) -> List[Finding]:
    """Every unwaived error across a report batch (gate helper)."""
    out: List[Finding] = []
    for r in reports:
        out.extend(r.errors)
    return out
