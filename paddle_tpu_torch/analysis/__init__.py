"""Whole-program static verifier over the ProgramDesc IR (the port's
counterpart of paddle_tpu/analysis/).

The reference front-loads correctness into compile time: every op runs
InferShape/InferVarType against the ProgramDesc before a kernel executes.
The port's executor interprets a block op by op and finds a mistake only
when a lowering throws. This package restores the compile-time story as a
pass pipeline over the IR, and adds a preflight of the port's fast paths:
which ops will miss a hand-written kernel, a window or a plan, and what
one-line change fixes it.

Passes (each a pure function over the program; see the sibling modules):

  shapes    (infer.py)    — re-derives every var's shape/dtype from the
                            feed/parameter leaves through per-op rules
                            keyed off ops/registry.py, with symbolic -1
                            batch dims, the op's own lowering run on
                            torch's `meta` device for long-tail ops, and
                            an explicit DYNAMIC_SHAPE_OPS allowlist.
  dataflow  (dataflow.py) — use-before-def, dead ops/vars relative to
                            the fetch set, write-after-write, persistable
                            fetch hazards, param<->grad pairing,
                            sparse-path reachability.
  preflight (preflight.py)— dry-runs the port's own gates: K1's conv gate,
                            the O3 quant gates, the sharding specs, the
                            fusion and overlap plans, the hot-row cache's
                            sizing and the planner's specs; emits fix-it
                            hints.

Severity semantics: "error" = the program will fail (or silently compute
garbage) at run time — PADDLE_TPU_VERIFY=1 turns these into
errors.ProgramVerifyError before the program's first step, and the
serving engine refuses such a program at admission; "warning" =
suspicious dataflow or a missed fast path worth a look (never raises);
"info" = advisory context (plan summaries).

Every Diagnostic carries the op index, op type, the offending var, the
Python source line the op was built at (Operator.creation_site) and,
where one is known, a concrete fix-it hint.

Entry points: analyze_program() here, the executor's PADDLE_TPU_VERIFY
hook (Executor._maybe_verify) and ServingEngine._admit.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

__all__ = [
    "Diagnostic", "Report", "SEVERITIES", "analyze_program", "pass_names",
]

SEVERITIES = ("error", "warning", "info")


@dataclass
class Diagnostic:
    """One finding. `site` is the user source line ("file:lineno") the op
    was built at; `hint` is an actionable one-liner when we know one."""

    severity: str
    code: str
    message: str
    pass_name: str = ""
    op_index: Optional[int] = None
    op_type: Optional[str] = None
    var: Optional[str] = None
    site: Optional[str] = None
    hint: Optional[str] = None

    def to_dict(self) -> Dict[str, Any]:
        return {k: v for k, v in self.__dict__.items() if v is not None}

    def format(self) -> str:
        where = ""
        if self.op_index is not None:
            where = f" [op {self.op_index} '{self.op_type}']"
        elif self.var:
            where = f" [var '{self.var}']"
        site = f" ({self.site})" if self.site else ""
        hint = f"\n      hint: {self.hint}" if self.hint else ""
        return (f"{self.severity}: {self.code}{where}{site}: "
                f"{self.message}{hint}")


@dataclass
class Report:
    diagnostics: List[Diagnostic] = field(default_factory=list)

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "error"]

    @property
    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "warning"]

    @property
    def infos(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "info"]

    @property
    def ok(self) -> bool:
        return not self.errors

    def counts(self) -> Dict[str, int]:
        c = {s: 0 for s in SEVERITIES}
        for d in self.diagnostics:
            c[d.severity] = c.get(d.severity, 0) + 1
        return c

    def to_dict(self) -> Dict[str, Any]:
        return {"counts": self.counts(),
                "diagnostics": [d.to_dict() for d in self.diagnostics]}

    def format(self, *, show_info: bool = True) -> str:
        c = self.counts()
        lines = [d.format() for d in self.diagnostics
                 if show_info or d.severity != "info"]
        lines.append(f"{c['error']} error(s), {c['warning']} warning(s), "
                     f"{c['info']} info")
        return "\n".join(lines)


class PassContext:
    """Shared state handed to each pass: the (read-only) program, the
    feed/fetch sets when the caller knows them, and the diagnostic sink.
    `ops` are the ORIGINAL Operator wrappers — their creation_site points
    at the user's model code, which cloned/re-synced wrappers lose."""

    def __init__(self, program, feeds: Optional[Sequence[str]],
                 fetches: Optional[Sequence[str]]):
        self.program = program
        self.block = program.global_block()
        self.ops = list(self.block.ops)
        self.feeds = set(feeds) if feeds is not None else None
        if fetches is None:
            fetches = list(getattr(program, "_loss_names", None) or [])
            self.fetches_explicit = False
        else:
            self.fetches_explicit = True
        self.fetches = [f if isinstance(f, str) else getattr(f, "name", str(f))
                        for f in fetches]
        self.diagnostics: List[Diagnostic] = []
        self._pass_name = ""

    def site_of(self, op_index: Optional[int]) -> Optional[str]:
        if op_index is None or not (0 <= op_index < len(self.ops)):
            return None
        return getattr(self.ops[op_index], "creation_site", None)

    def emit(self, severity: str, code: str, message: str, *,
             op_index: Optional[int] = None, var: Optional[str] = None,
             hint: Optional[str] = None) -> Diagnostic:
        assert severity in SEVERITIES, severity
        op_type = (self.ops[op_index].type
                   if op_index is not None and 0 <= op_index < len(self.ops)
                   else None)
        d = Diagnostic(severity=severity, code=code, message=message,
                       pass_name=self._pass_name, op_index=op_index,
                       op_type=op_type, var=var,
                       site=self.site_of(op_index), hint=hint)
        self.diagnostics.append(d)
        return d


def _passes():
    from . import dataflow, infer, preflight
    return [("shapes", infer.run), ("dataflow", dataflow.run),
            ("preflight", preflight.run)]


def pass_names() -> List[str]:
    return [n for n, _ in _passes()]


def analyze_program(program, feeds: Optional[Sequence[str]] = None,
                    fetches: Optional[Sequence[str]] = None) -> Report:
    """Run every pass over `program`'s global block and return the Report.

    `feeds`/`fetches` sharpen the dataflow checks when the caller knows
    them (the executor and CLI do); without them, no-producer vars are
    presumed feedable and the fetch set falls back to the loss names
    recorded by append_backward. Never raises: a pass that dies on an
    analyzer bug degrades to a single `analyzer-internal` warning so the
    crash-report and bench integrations stay harmless.
    """
    ctx = PassContext(program, feeds, fetches)
    for name, fn in _passes():
        ctx._pass_name = name
        try:
            fn(ctx)
        except Exception as e:  # noqa: BLE001 - analyzer must not crash
            ctx.emit("warning", "analyzer-internal",
                     f"'{name}' pass failed internally: {e!r}")
    ctx._pass_name = ""
    return Report(ctx.diagnostics)
