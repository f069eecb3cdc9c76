"""Versioned schema migrations.

Plain copy of ``pde_tpu/database/migrations.py`` (host-side Python, no numerics
of its own): the port keeps its own copy because importing any module of
``pde_tpu`` imports JAX.

The reference manages schema with Alembic + raw SQL (alembic/versions/,
sql/schema.sql).  This is the portable analog: ordered migrations applied
against a ``schema_version`` table, idempotent and forward-only (the standard
production posture — downgrade = restore from backup).
"""

from __future__ import annotations

from dataclasses import dataclass
from datetime import datetime, timezone
from typing import Callable, Dict, List

__all__ = ["Migration", "MigrationRunner", "MIGRATIONS"]


@dataclass
class Migration:
    version: int
    name: str
    sql: str
    # tables to convert to TimescaleDB hypertables after the DDL runs
    # (applied only on a server with the extension; requires the table's
    # primary key to include the time column)
    hypertables: tuple = ()


# The baseline schema ships in database/db.py (v1); migrations evolve it.
MIGRATIONS: List[Migration] = [
    Migration(
        2,
        "add_calibration_runs",
        """
        CREATE TABLE IF NOT EXISTS calibration_runs (
            run_id INTEGER PRIMARY KEY AUTOINCREMENT,
            time TEXT NOT NULL,
            underlying TEXT NOT NULL,
            status TEXT NOT NULL,
            n_options INTEGER,
            errors TEXT,
            run_time_s REAL
        );
        CREATE INDEX IF NOT EXISTS idx_calruns ON calibration_runs (underlying, time);
        """,
    ),
    Migration(
        3,
        "add_fills_table",
        """
        CREATE TABLE IF NOT EXISTS fills (
            fill_id TEXT PRIMARY KEY,
            order_id TEXT NOT NULL,
            time TEXT NOT NULL,
            symbol TEXT NOT NULL,
            side TEXT NOT NULL,
            quantity REAL NOT NULL,
            price REAL NOT NULL,
            commission REAL DEFAULT 0,
            venue TEXT
        );
        CREATE INDEX IF NOT EXISTS idx_fills_order ON fills (order_id);
        """,
    ),
    Migration(
        4,
        "add_equity_curve",
        """
        CREATE TABLE IF NOT EXISTS equity_curve (
            time TEXT NOT NULL PRIMARY KEY,
            equity REAL NOT NULL,
            cash REAL,
            gross_exposure REAL
        );
        """,
        hypertables=("equity_curve",),
    ),
]


class MigrationRunner:
    """Applies pending migrations in order (the alembic-upgrade analog).

    Engine-neutral: goes through the ``TimeSeriesDB`` run_query/run_script
    surface, so the same migration set upgrades the embedded sqlite store
    and a postgresql/TimescaleDB server (the engine translates the DDL
    dialect — AUTOINCREMENT, time columns — exactly as for the baseline
    schema)."""

    def __init__(self, db):
        self.db = db
        self._ensure_version_table()

    def _ensure_version_table(self) -> None:
        self.db.run_script(
            "CREATE TABLE IF NOT EXISTS schema_version ("
            " version INTEGER PRIMARY KEY, name TEXT, applied_at TEXT)"
        )
        n = self.db.run_query("SELECT COUNT(*) AS n FROM schema_version")[0]["n"]
        if n == 0:
            self.db.run_execute(
                "INSERT INTO schema_version VALUES (1, 'baseline', ?)",
                (datetime.now(timezone.utc).isoformat(),),
            )

    @property
    def current_version(self) -> int:
        return self.db.run_query(
            "SELECT MAX(version) AS v FROM schema_version")[0]["v"]

    def pending(self) -> List[Migration]:
        v = self.current_version
        return [m for m in sorted(MIGRATIONS, key=lambda m: m.version) if m.version > v]

    def upgrade(self) -> List[int]:
        """Apply all pending migrations; returns applied versions."""
        applied = []
        for m in self.pending():
            self.db.run_script(m.sql)
            if m.hypertables and getattr(self.db, "is_timescale", False):
                for table in m.hypertables:
                    try:
                        self.db.run_execute(
                            "SELECT create_hypertable(?, 'time',"
                            " if_not_exists => TRUE, migrate_data => TRUE)",
                            (table,),
                        )
                    except Exception:  # noqa: BLE001 - plain-PG fallback
                        pass
            self.db.run_execute(
                "INSERT INTO schema_version VALUES (?, ?, ?)",
                (m.version, m.name, datetime.now(timezone.utc).isoformat()),
            )
            applied.append(m.version)
        return applied

    def history(self) -> List[Dict]:
        return [
            {"version": r["version"], "name": r["name"],
             "applied_at": r["applied_at"]}
            for r in self.db.run_query(
                "SELECT version, name, applied_at FROM schema_version"
                " ORDER BY version")
        ]
