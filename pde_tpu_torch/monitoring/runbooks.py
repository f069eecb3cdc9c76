"""Executable incident runbooks.

Plain copy of ``pde_tpu/monitoring/runbooks.py`` (host-side Python, no numerics
of its own): the port keeps its own copy because importing any module of
``pde_tpu`` imports JAX.

Mirrors the reference monitoring/runbooks.py: the runbook framework with
typed steps (:50-178), the registry (:179-241) and the six default incident
runbooks — high drawdown, data staleness, calibration failure, high CPU,
order rejections, cointegration breakdown (:242-580).  Steps carry optional
automated actions so a runbook can be *executed*, not just read.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import Callable, Dict, List, Optional

__all__ = ["StepKind", "RunbookStep", "StepResult", "Runbook", "RunbookRegistry", "default_registry"]


class StepKind(str, enum.Enum):
    CHECK = "check"  # gather information
    ACTION = "action"  # perform a mitigation
    ESCALATE = "escalate"  # notify a human
    VERIFY = "verify"  # confirm recovery


@dataclass
class RunbookStep:
    title: str
    kind: StepKind
    instruction: str
    automated: Optional[Callable[[Dict], Dict]] = None  # context -> findings


@dataclass
class StepResult:
    step: str
    executed: bool
    findings: Dict = field(default_factory=dict)
    error: Optional[str] = None


@dataclass
class Runbook:
    name: str
    trigger: str
    severity: str
    steps: List[RunbookStep] = field(default_factory=list)

    def execute(self, context: Optional[Dict] = None) -> List[StepResult]:
        """Run automated steps; manual steps are reported as instructions."""
        context = dict(context or {})
        results = []
        for step in self.steps:
            if step.automated is None:
                results.append(StepResult(step.title, executed=False,
                                          findings={"instruction": step.instruction}))
                continue
            try:
                findings = step.automated(context) or {}
                context.update(findings)
                results.append(StepResult(step.title, executed=True, findings=findings))
            except Exception as exc:  # noqa: BLE001 - runbooks degrade to manual
                results.append(StepResult(step.title, executed=False, error=str(exc),
                                          findings={"instruction": step.instruction}))
        return results

    def to_markdown(self) -> str:
        lines = [f"# Runbook: {self.name}", f"**Trigger:** {self.trigger}",
                 f"**Severity:** {self.severity}", ""]
        for i, s in enumerate(self.steps, 1):
            auto = " (automated)" if s.automated else ""
            lines.append(f"{i}. **[{s.kind.value}]** {s.title}{auto}: {s.instruction}")
        return "\n".join(lines)


class RunbookRegistry:
    """Lookup + execution log (runbooks.py:179-241)."""

    def __init__(self):
        self._runbooks: Dict[str, Runbook] = {}
        self.execution_log: List[Dict] = []

    def register(self, runbook: Runbook) -> None:
        self._runbooks[runbook.name] = runbook

    def get(self, name: str) -> Optional[Runbook]:
        return self._runbooks.get(name)

    def list(self) -> List[str]:
        return sorted(self._runbooks)

    def execute(self, name: str, context: Optional[Dict] = None) -> List[StepResult]:
        rb = self._runbooks[name]
        results = rb.execute(context)
        self.execution_log.append(
            {
                "runbook": name,
                "time": datetime.now(timezone.utc).isoformat(),
                "n_steps": len(results),
                "n_automated": sum(r.executed for r in results),
            }
        )
        return results


def default_registry(trading_system=None) -> RunbookRegistry:
    """The six default incident runbooks (runbooks.py:242-580).  When a
    trading_system is supplied, mitigation steps wire to real actions."""
    reg = RunbookRegistry()

    def halt_action(ctx):
        if trading_system is not None and hasattr(trading_system, "halt_trading"):
            trading_system.halt_trading(reason=ctx.get("reason", "runbook"))
            return {"halted": True}
        return {"halted": False, "note": "no trading system attached"}

    reg.register(Runbook(
        name="high_drawdown",
        trigger="current_drawdown > 15%",
        severity="critical",
        steps=[
            RunbookStep("Confirm drawdown", StepKind.CHECK,
                        "Compare portfolio value against the recorded peak; rule out a pricing glitch."),
            RunbookStep("Reduce exposure", StepKind.ACTION,
                        "Apply the drawdown controller's exposure multiplier to all new sizing."),
            RunbookStep("Halt if critical", StepKind.ACTION,
                        "At >25% engage the kill switch.", automated=halt_action),
            RunbookStep("Escalate", StepKind.ESCALATE, "Page the risk owner."),
            RunbookStep("Verify", StepKind.VERIFY, "Confirm exposure reduced and drawdown stabilized."),
        ],
    ))
    reg.register(Runbook(
        name="data_staleness",
        trigger="no market data for > 24h",
        severity="error",
        steps=[
            RunbookStep("Check provider health", StepKind.CHECK,
                        "Inspect DataQualityMonitor.report() provider error rates."),
            RunbookStep("Failover provider", StepKind.ACTION,
                        "Switch the ingestion pipeline to the secondary provider."),
            RunbookStep("Backfill", StepKind.ACTION,
                        "Run GapDetector + BackfillManager over the stale window."),
            RunbookStep("Verify", StepKind.VERIFY, "Quality monitor reports GOOD freshness."),
        ],
    ))
    reg.register(Runbook(
        name="calibration_failure",
        trigger="calibration RMSE above limit or non-convergence",
        severity="error",
        steps=[
            RunbookStep("Inspect inputs", StepKind.CHECK,
                        "Validate the option chain (OptionsDataValidator); stale/crossed quotes are the usual cause."),
            RunbookStep("Use cached parameters", StepKind.ACTION,
                        "Serve yesterday's parameters (use_cached_on_failure path)."),
            RunbookStep("Re-run with warm start", StepKind.ACTION,
                        "Retry calibration warm-started from the cached parameters."),
            RunbookStep("Suspend signals", StepKind.ACTION,
                        "If still failing, disable vol-arb signals for the underlying."),
            RunbookStep("Verify", StepKind.VERIFY, "RMSE back under threshold and Feller satisfied."),
        ],
    ))
    reg.register(Runbook(
        name="high_cpu",
        trigger="sustained CPU > 90%",
        severity="warning",
        steps=[
            RunbookStep("Identify hot component", StepKind.CHECK,
                        "Check latency histograms; calibration and backtests dominate compute."),
            RunbookStep("Shed load", StepKind.ACTION,
                        "Reduce calibration frequency / defer batch jobs."),
            RunbookStep("Scale out", StepKind.ACTION,
                        "Add devices to the mesh (dp axis) or another host."),
            RunbookStep("Verify", StepKind.VERIFY, "CPU back below 70%."),
        ],
    ))
    reg.register(Runbook(
        name="order_rejections",
        trigger="order reject rate > 10%",
        severity="error",
        steps=[
            RunbookStep("Classify rejections", StepKind.CHECK,
                        "Group order-manager events by rejection rule."),
            RunbookStep("Fix limits or halt", StepKind.ACTION,
                        "If fat-finger limits misconfigured fix them; if risk breaches, halt.",
                        automated=halt_action),
            RunbookStep("Escalate", StepKind.ESCALATE, "Notify the execution owner."),
            RunbookStep("Verify", StepKind.VERIFY, "Reject rate back under 2%."),
        ],
    ))
    reg.register(Runbook(
        name="cointegration_breakdown",
        trigger="pair health CRITICAL/FAILED",
        severity="error",
        steps=[
            RunbookStep("Re-test relationship", StepKind.CHECK,
                        "Run CorrelationMonitor.check_pair_health on fresh data."),
            RunbookStep("Close affected pairs", StepKind.ACTION,
                        "Follow get_position_recommendations: close/close_immediately."),
            RunbookStep("Quarantine pair", StepKind.ACTION,
                        "Remove the pair from the tradeable universe pending review."),
            RunbookStep("Verify", StepKind.VERIFY, "No open exposure to the broken pair."),
        ],
    ))
    return reg
