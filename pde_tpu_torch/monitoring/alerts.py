"""Alerting: model, rules, channels, dedup, escalation, manager.

Plain copy of ``pde_tpu/monitoring/alerts.py`` (host-side Python): the
port keeps its own copy because importing any module of ``pde_tpu``
imports JAX.  Its ``requests`` and ``smtplib`` imports stay inside the
channels that send, so importing the module reaches no network.

Mirrors the reference monitoring/alerts.py: the Alert model with severities
(:60-228), threshold rules, channels (Log / Slack / Email / PagerDuty /
Webhook; :252-548), dedup + acknowledgement + escalation in the AlertManager
(:569-997) and the default rule set (:998-1157).
"""

from __future__ import annotations

import enum
import json
import threading
import uuid
from dataclasses import dataclass, field
from datetime import datetime, timedelta, timezone
from typing import Any, Callable, Dict, List, Optional

__all__ = [
    "AlertSeverity",
    "Alert",
    "AlertRule",
    "AlertChannel",
    "LogChannel",
    "WebhookChannel",
    "SlackChannel",
    "EmailChannel",
    "PagerDutyChannel",
    "AlertManager",
    "default_rules",
]


class AlertSeverity(str, enum.Enum):
    INFO = "info"
    WARNING = "warning"
    ERROR = "error"
    CRITICAL = "critical"

    @property
    def rank(self) -> int:
        return ["info", "warning", "error", "critical"].index(self.value)


@dataclass
class Alert:
    title: str
    message: str
    severity: AlertSeverity = AlertSeverity.WARNING
    source: str = ""
    alert_id: str = field(default_factory=lambda: str(uuid.uuid4()))
    timestamp: datetime = field(default_factory=lambda: datetime.now(timezone.utc))
    acknowledged: bool = False
    acknowledged_by: Optional[str] = None
    metadata: Dict[str, Any] = field(default_factory=dict)

    @property
    def dedup_key(self) -> str:
        return f"{self.source}:{self.title}"

    def to_dict(self) -> Dict:
        d = dict(self.__dict__)
        d["severity"] = self.severity.value
        d["timestamp"] = self.timestamp.isoformat()
        return d


@dataclass
class AlertRule:
    """value-vs-threshold rule (alerts.py rules)."""

    name: str
    metric: str
    threshold: float
    direction: str = "above"  # fire when value is above/below threshold
    severity: AlertSeverity = AlertSeverity.WARNING
    message_template: str = "{metric} = {value:.4g} breached {threshold:.4g}"

    def evaluate(self, value: float) -> Optional[Alert]:
        fired = value > self.threshold if self.direction == "above" else value < self.threshold
        if not fired:
            return None
        return Alert(
            title=self.name,
            message=self.message_template.format(
                metric=self.metric, value=value, threshold=self.threshold
            ),
            severity=self.severity,
            source=self.metric,
            metadata={"value": value, "threshold": self.threshold},
        )


class AlertChannel:
    """Channel interface (alerts.py:252-300)."""

    name = "base"
    min_severity = AlertSeverity.INFO

    def send(self, alert: Alert) -> bool:
        raise NotImplementedError


class LogChannel(AlertChannel):
    name = "log"

    def __init__(self, sink: Optional[Callable[[str], None]] = None):
        import logging

        self._log = sink or logging.getLogger("pde_tpu_torch.alerts").warning

    def send(self, alert: Alert) -> bool:
        self._log(f"[{alert.severity.value.upper()}] {alert.title}: {alert.message}")
        return True


class WebhookChannel(AlertChannel):
    name = "webhook"

    def __init__(self, url: str, min_severity: AlertSeverity = AlertSeverity.WARNING):
        self.url = url
        self.min_severity = min_severity

    def send(self, alert: Alert) -> bool:  # pragma: no cover - network
        import requests

        resp = requests.post(self.url, json=alert.to_dict(), timeout=5)
        return resp.ok


class SlackChannel(WebhookChannel):
    name = "slack"

    def send(self, alert: Alert) -> bool:  # pragma: no cover - network
        import requests

        emoji = {"info": ":information_source:", "warning": ":warning:",
                 "error": ":x:", "critical": ":rotating_light:"}[alert.severity.value]
        resp = requests.post(
            self.url,
            json={"text": f"{emoji} *{alert.title}*\n{alert.message}"},
            timeout=5,
        )
        return resp.ok


class EmailChannel(AlertChannel):
    name = "email"
    min_severity = AlertSeverity.ERROR

    def __init__(self, smtp_host: str, to_addrs: List[str], from_addr: str = "alerts@pde-tpu"):
        self.smtp_host = smtp_host
        self.to_addrs = to_addrs
        self.from_addr = from_addr

    def send(self, alert: Alert) -> bool:  # pragma: no cover - network
        import smtplib
        from email.message import EmailMessage

        msg = EmailMessage()
        msg["Subject"] = f"[{alert.severity.value.upper()}] {alert.title}"
        msg["From"] = self.from_addr
        msg["To"] = ", ".join(self.to_addrs)
        msg.set_content(alert.message + "\n\n" + json.dumps(alert.metadata, default=str))
        with smtplib.SMTP(self.smtp_host) as smtp:
            smtp.send_message(msg)
        return True


class PagerDutyChannel(AlertChannel):
    name = "pagerduty"
    min_severity = AlertSeverity.CRITICAL

    def __init__(self, routing_key: str):
        self.routing_key = routing_key

    def send(self, alert: Alert) -> bool:  # pragma: no cover - network
        import requests

        resp = requests.post(
            "https://events.pagerduty.com/v2/enqueue",
            json={
                "routing_key": self.routing_key,
                "event_action": "trigger",
                "payload": {
                    "summary": f"{alert.title}: {alert.message}",
                    "severity": alert.severity.value,
                    "source": alert.source or "pde_tpu_torch",
                },
            },
            timeout=5,
        )
        return resp.ok


class AlertManager:
    """Dedup + routing + escalation (alerts.py:569-997)."""

    def __init__(
        self,
        channels: Optional[List[AlertChannel]] = None,
        dedup_window: timedelta = timedelta(minutes=5),
        escalation_after: int = 3,
    ):
        self.channels = channels or [LogChannel()]
        self.dedup_window = dedup_window
        self.escalation_after = escalation_after
        self.rules: List[AlertRule] = []
        self.history: List[Alert] = []
        self._last_fired: Dict[str, datetime] = {}
        self._repeat_count: Dict[str, int] = {}
        self._lock = threading.Lock()

    def add_rule(self, rule: AlertRule) -> None:
        self.rules.append(rule)

    def add_channel(self, channel: AlertChannel) -> None:
        self.channels.append(channel)

    def evaluate_rules(self, metrics: Dict[str, float]) -> List[Alert]:
        fired = []
        for rule in self.rules:
            if rule.metric in metrics:
                alert = rule.evaluate(metrics[rule.metric])
                if alert is not None:
                    self.fire(alert)
                    fired.append(alert)
        return fired

    def fire(self, alert: Alert) -> bool:
        """Dedup, escalate on repeats, route to channels by severity."""
        with self._lock:
            key = alert.dedup_key
            last = self._last_fired.get(key)
            if last is not None and alert.timestamp - last < self.dedup_window:
                self._repeat_count[key] = self._repeat_count.get(key, 0) + 1
                if self._repeat_count[key] >= self.escalation_after and alert.severity.rank < AlertSeverity.CRITICAL.rank:
                    alert.severity = AlertSeverity(
                        ["info", "warning", "error", "critical"][alert.severity.rank + 1]
                    )
                    alert.metadata["escalated"] = True
                    self._repeat_count[key] = 0
                else:
                    return False  # deduped
            self._last_fired[key] = alert.timestamp
            self.history.append(alert)

        delivered = False
        for ch in self.channels:
            if alert.severity.rank >= ch.min_severity.rank:
                try:
                    delivered = ch.send(alert) or delivered
                except Exception:  # noqa: BLE001 - channels must not break firing
                    continue
        return delivered

    def acknowledge(self, alert_id: str, by: str = "") -> bool:
        for alert in self.history:
            if alert.alert_id == alert_id:
                alert.acknowledged = True
                alert.acknowledged_by = by
                return True
        return False

    def active_alerts(self, min_severity: AlertSeverity = AlertSeverity.INFO) -> List[Alert]:
        return [
            a for a in self.history
            if not a.acknowledged and a.severity.rank >= min_severity.rank
        ]


def default_rules() -> List[AlertRule]:
    """Default rule set (alerts.py:998-1157)."""
    return [
        AlertRule("high_drawdown", "current_drawdown", 0.15, "above", AlertSeverity.ERROR),
        AlertRule("critical_drawdown", "current_drawdown", 0.25, "above", AlertSeverity.CRITICAL),
        AlertRule("daily_loss", "daily_pnl_pct", -0.03, "below", AlertSeverity.ERROR),
        AlertRule("var_limit", "var_95_pct", 0.02, "above", AlertSeverity.WARNING),
        AlertRule("calibration_rmse", "calibration_rmse", 0.5, "above", AlertSeverity.WARNING),
        AlertRule("data_staleness_hours", "data_staleness_hours", 24.0, "above", AlertSeverity.WARNING),
        AlertRule("order_reject_rate", "order_reject_rate", 0.10, "above", AlertSeverity.ERROR),
    ]
