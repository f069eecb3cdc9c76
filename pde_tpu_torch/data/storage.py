"""Storage management: retention, compaction, storage stats.

Plain copy of ``pde_tpu/data/storage.py`` (host-side Python, no numerics
of its own): the port keeps its own copy because importing any module of
``pde_tpu`` imports JAX.

Mirrors the reference data/storage.py: TimescaleDB hypertable / compression /
retention / continuous-aggregate management (:86-706) and the
DataRetentionManager (:707-804) — recast for the portable sqlite engine:
retention = windowed deletes, compression = downsampling old ticks to daily
bars, continuous aggregates = materialized summary tables, plus VACUUM-based
compaction and size accounting.  A server-backed engine can implement the
same manager interface with native hypertable DDL.
"""

from __future__ import annotations

from dataclasses import dataclass
from datetime import date, datetime, timedelta, timezone
from typing import Dict, List, Optional

__all__ = ["RetentionPolicy", "StorageStats", "StorageManager", "DataRetentionManager"]


@dataclass
class RetentionPolicy:
    table: str
    keep_days: int
    time_column: str = "time"


@dataclass
class StorageStats:
    total_bytes: int
    table_rows: Dict[str, int]
    oldest: Dict[str, Optional[str]]
    newest: Dict[str, Optional[str]]


_TABLES = ("market_prices", "option_quotes", "model_parameters", "signals",
           "positions", "position_updates")


class StorageManager:
    """Admin operations over a TimeSeriesDB (storage.py:86-706).

    SQLITE ENGINE ONLY (raw-connection admin: PRAGMAs, VACUUM); the
    server engine's counterpart is
    :class:`pde_tpu_torch.database.timescale.TimescaleManager` (hypertables,
    native compression, continuous aggregates)."""

    def __init__(self, db):
        self.db = db

    def stats(self) -> StorageStats:
        con = self.db._conn()
        rows, oldest, newest = {}, {}, {}
        for t in _TABLES:
            rows[t] = con.execute(f"SELECT COUNT(*) FROM {t}").fetchone()[0]
            if t in ("market_prices", "option_quotes", "model_parameters", "signals",
                     "position_updates"):
                lo = con.execute(f"SELECT MIN(time) FROM {t}").fetchone()[0]
                hi = con.execute(f"SELECT MAX(time) FROM {t}").fetchone()[0]
                oldest[t], newest[t] = lo, hi
        page_count = con.execute("PRAGMA page_count").fetchone()[0]
        page_size = con.execute("PRAGMA page_size").fetchone()[0]
        return StorageStats(
            total_bytes=page_count * page_size, table_rows=rows, oldest=oldest, newest=newest
        )

    def create_daily_aggregate(self) -> int:
        """Materialize per-day OHLCV from market_prices — the continuous
        aggregate analog (storage.py continuous aggregates)."""
        con = self.db._conn()
        con.executescript(
            """
            CREATE TABLE IF NOT EXISTS market_prices_daily (
                day TEXT NOT NULL,
                symbol TEXT NOT NULL,
                open REAL, high REAL, low REAL, close REAL, volume REAL,
                PRIMARY KEY (day, symbol)
            );
            """
        )
        with self.db._lock, con:
            con.execute(
                """
                INSERT OR REPLACE INTO market_prices_daily
                SELECT substr(time, 1, 10) AS day, symbol,
                       (SELECT open FROM market_prices i
                        WHERE i.symbol = o.symbol AND substr(i.time,1,10) = substr(o.time,1,10)
                        ORDER BY i.time LIMIT 1),
                       MAX(high), MIN(low),
                       (SELECT close FROM market_prices i
                        WHERE i.symbol = o.symbol AND substr(i.time,1,10) = substr(o.time,1,10)
                        ORDER BY i.time DESC LIMIT 1),
                       SUM(volume)
                FROM market_prices o
                GROUP BY day, symbol
                """
            )
        return con.execute("SELECT COUNT(*) FROM market_prices_daily").fetchone()[0]

    def compact(self) -> None:
        """Reclaim space (VACUUM; the compression-job analog)."""
        # VACUUM cannot run inside a transaction
        con = self.db._conn()
        con.commit()
        con.execute("VACUUM")


class DataRetentionManager:
    """Windowed retention enforcement (storage.py:707-804)."""

    DEFAULT_POLICIES = [
        RetentionPolicy("option_quotes", keep_days=365),
        RetentionPolicy("signals", keep_days=730),
        RetentionPolicy("position_updates", keep_days=1825),
    ]

    def __init__(self, db, policies: Optional[List[RetentionPolicy]] = None):
        self.db = db
        self.policies = policies or list(self.DEFAULT_POLICIES)

    def enforce(self, as_of: Optional[datetime] = None) -> Dict[str, int]:
        """Delete rows older than each policy window; returns deletions."""
        as_of = as_of or datetime.now(timezone.utc)
        out = {}
        con = self.db._conn()
        for policy in self.policies:
            cutoff = (as_of - timedelta(days=policy.keep_days)).isoformat()
            with self.db._lock, con:
                cur = con.execute(
                    f"DELETE FROM {policy.table} WHERE {policy.time_column} < ?", (cutoff,)
                )
            out[policy.table] = cur.rowcount
        return out

    def add_policy(self, policy: RetentionPolicy) -> None:
        self.policies.append(policy)
