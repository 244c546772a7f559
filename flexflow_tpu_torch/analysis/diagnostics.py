"""fflint's shared diagnostic model.

PyTorch counterpart of ``flexflow_tpu/analysis/diagnostics.py``, line for
line: the two packages' reports of one graph serialize to the same JSON.

Every pass (``flexflow_tpu_torch/analysis/passes``) emits ``Diagnostic``
records: a stable rule id (``FFL###`` — the catalog lives in README
§fflint), a severity, the op/tensor the finding anchors to, and a fix
hint. The ``LintReport`` aggregates them across passes and renders both
the human table (``format_human``) and the machine form (``to_json``)
consumed by ``python -m flexflow_tpu_torch.scripts.fflint --json``.

Severity contract (enforced by tests/test_torch_port_analysis.py):

* ``ERROR``   — the strategy/graph is wrong: it will deadlock, compute
  the wrong thing, or run collectives the simulator never priced (the
  searched strategy's prediction is meaningless). The fflint CLI exits
  nonzero and ``compile(lint="error")`` raises.
* ``WARNING`` — legal but wasteful or fragile (redundant transpose
  pairs, dead ops, stale calibration).
* ``INFO``    — context a reviewer wants (pass skipped for a stated
  reason, coverage notes).
"""

from __future__ import annotations

import dataclasses
import enum
import json
from typing import Any, Dict, List, Optional


class Severity(enum.Enum):
    ERROR = "error"
    WARNING = "warning"
    INFO = "info"

    def __lt__(self, other):  # ERROR sorts first in reports
        order = {"error": 0, "warning": 1, "info": 2}
        return order[self.value] < order[other.value]


@dataclasses.dataclass
class Diagnostic:
    """One finding. ``rule`` is the stable FFL### id; ``op`` names the
    operator (or None for graph-level findings); ``tensor`` names the
    specific tensor/parameter when the finding is narrower than the op."""

    rule: str
    severity: Severity
    message: str
    op: Optional[str] = None
    guid: Optional[int] = None
    tensor: Optional[str] = None
    hint: Optional[str] = None
    lint_pass: Optional[str] = None

    def to_json(self) -> Dict[str, Any]:
        return dict(
            rule=self.rule,
            severity=self.severity.value,
            message=self.message,
            op=self.op,
            guid=self.guid,
            tensor=self.tensor,
            hint=self.hint,
            # "pass" is a keyword in Python but the natural JSON key
            **{"pass": self.lint_pass},
        )

    def format(self) -> str:
        loc = self.op or "<graph>"
        if self.tensor:
            loc = f"{loc}:{self.tensor}"
        line = f"{self.severity.value.upper():7s} {self.rule} [{loc}] {self.message}"
        if self.hint:
            line += f"\n        hint: {self.hint}"
        return line


class LintReport:
    """Diagnostics from one orchestrator run, plus per-pass status
    (ran / skipped / crashed) so "no findings" is distinguishable from
    "pass never ran"."""

    def __init__(self):
        self.diagnostics: List[Diagnostic] = []
        self.passes: Dict[str, str] = {}  # pass name -> "ok"/"skipped: .."/"crashed: .."
        self.context: Dict[str, Any] = {}

    def extend(self, diags: List[Diagnostic], lint_pass: str) -> None:
        for d in diags:
            if d.lint_pass is None:
                d.lint_pass = lint_pass
        self.diagnostics.extend(diags)

    # ---- queries -----------------------------------------------------------
    def by_severity(self, severity: Severity) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == severity]

    @property
    def errors(self) -> List[Diagnostic]:
        return self.by_severity(Severity.ERROR)

    @property
    def warnings(self) -> List[Diagnostic]:
        return self.by_severity(Severity.WARNING)

    def by_rule(self, rule: str) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.rule == rule]

    def has_errors(self) -> bool:
        return bool(self.errors)

    # ---- rendering ---------------------------------------------------------
    def to_json(self) -> Dict[str, Any]:
        counts = dict(error=len(self.errors), warning=len(self.warnings),
                      info=len(self.by_severity(Severity.INFO)))
        return dict(
            context=self.context,
            passes=self.passes,
            counts=counts,
            diagnostics=[d.to_json() for d in
                         sorted(self.diagnostics,
                                key=lambda d: (d.severity, d.rule))],
        )

    def dumps(self, indent: int = 1) -> str:
        return json.dumps(self.to_json(), indent=indent)

    def format_human(self) -> str:
        lines = []
        if self.context:
            ctx = ", ".join(f"{k}={v}" for k, v in self.context.items())
            lines.append(f"fflint: {ctx}")
        for name, status in self.passes.items():
            if status != "ok":
                lines.append(f"pass {name}: {status}")
        for d in sorted(self.diagnostics, key=lambda d: (d.severity, d.rule)):
            lines.append(d.format())
        lines.append(
            f"{len(self.errors)} error(s), {len(self.warnings)} warning(s), "
            f"{len(self.by_severity(Severity.INFO))} info "
            f"({sum(1 for s in self.passes.values() if s == 'ok')}/"
            f"{len(self.passes)} passes ran)")
        return "\n".join(lines)


def error(rule: str, message: str, **kw) -> Diagnostic:
    return Diagnostic(rule, Severity.ERROR, message, **kw)


def warning(rule: str, message: str, **kw) -> Diagnostic:
    return Diagnostic(rule, Severity.WARNING, message, **kw)


def info(rule: str, message: str, **kw) -> Diagnostic:
    return Diagnostic(rule, Severity.INFO, message, **kw)
