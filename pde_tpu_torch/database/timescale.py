"""TimescaleDB administration over the server engine.

Plain copy of ``pde_tpu/database/timescale.py`` (host-side Python, no numerics
of its own): the port keeps its own copy because importing any module of
``pde_tpu`` imports JAX.  Two changes: the compression and retention
policies bind their interval as ``CAST(? AS interval)``; the reference's
``INTERVAL ?`` becomes ``INTERVAL $2`` on the wire, which PostgreSQL
refuses when it parses the statement (the ``INTERVAL '...'`` literal takes
a string constant, not a parameter).  And ``enable_compression`` checks
its ``segment_by`` columns before any statement runs, where the reference
writes the string into its DDL unchecked.

The PG-engine analog of :mod:`pde_tpu_torch.data.storage` (whose
StorageManager/DataRetentionManager administer the embedded sqlite
engine), mirroring the reference's TimescaleManager/DataRetentionManager
(the reference's quant_trading/data/storage.py:86-804):
hypertable introspection, native compression policies, retention
policies, and a continuous-aggregate daily OHLCV rollup.

Everything issues plain SQL through the engine-neutral
``TimeSeriesDB.run_query``/``run_execute`` surface.  Table names are
validated against the known schema, and ``segment_by``'s column names
against the SQL identifier pattern, before any statement is sent: those
are the only identifiers written into SQL, and values are bound as
parameters.  Exercised by the live-server integration tests
(``PDE_TEST_PG_URL``; the CI TimescaleDB service container).
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional

__all__ = ["TimescaleManager"]

_KNOWN_TABLES = frozenset({
    "market_prices", "option_quotes", "model_parameters", "signals",
    "position_updates", "equity_curve", "calibration_runs", "fills",
})


def _check_table(table: str) -> str:
    if table not in _KNOWN_TABLES:
        raise ValueError(f"unknown table {table!r}")
    return table


def _check_columns(columns: str) -> str:
    """``columns``, a comma-separated list of plain column names (spaces
    around each allowed); ``ValueError`` for anything else."""
    for name in columns.split(","):
        if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", name.strip(" ")):
            raise ValueError(f"not a column name: {name!r} in segment_by {columns!r}")
    return columns


class TimescaleManager:
    """Hypertable/compression/retention/rollup management
    (storage.py:86-707)."""

    def __init__(self, db):
        if db.engine_name != "postgresql":
            raise ValueError(
                "TimescaleManager needs the postgresql engine; the sqlite "
                "engine's analog is pde_tpu_torch.data.storage.StorageManager")
        if not db.is_timescale:
            raise ValueError("server has no timescaledb extension")
        self.db = db

    # --------------------------------------------------------- hypertables

    def hypertables(self) -> List[Dict[str, Any]]:
        return self.db.run_query(
            "SELECT hypertable_name, num_chunks, compression_enabled"
            " FROM timescaledb_information.hypertables"
        )

    def chunk_stats(self, table: str) -> List[Dict[str, Any]]:
        return self.db.run_query(
            "SELECT chunk_name, range_start::text, range_end::text,"
            " is_compressed FROM timescaledb_information.chunks"
            " WHERE hypertable_name = ?",
            (_check_table(table),),
        )

    def table_size_bytes(self, table: str) -> int:
        rows = self.db.run_query(
            "SELECT hypertable_size(?) AS n", (_check_table(table),))
        return int(rows[0]["n"] or 0)

    # --------------------------------------------------------- compression

    def enable_compression(
        self,
        table: str,
        compress_after: str = "7 days",
        segment_by: Optional[str] = None,
    ) -> None:
        """Native columnar compression + an automatic policy
        (storage.py compression management)."""
        t = _check_table(table)
        seg = f", timescaledb.compress_segmentby = '{_check_columns(segment_by)}'" \
            if segment_by else ""
        self.db.run_script(
            f"ALTER TABLE {t} SET (timescaledb.compress{seg})")
        self.db.run_execute(
            "SELECT add_compression_policy(?, CAST(? AS interval),"
            " if_not_exists => TRUE)",
            (t, compress_after),
        )

    # ----------------------------------------------------------- retention

    def add_retention_policy(self, table: str,
                             drop_after: str = "365 days") -> None:
        self.db.run_execute(
            "SELECT add_retention_policy(?, CAST(? AS interval),"
            " if_not_exists => TRUE)",
            (_check_table(table), drop_after),
        )

    def drop_retention_policy(self, table: str) -> None:
        self.db.run_execute(
            "SELECT remove_retention_policy(?, if_exists => TRUE)",
            (_check_table(table),),
        )

    # ------------------------------------------------- continuous aggregate

    def create_daily_rollup(self) -> None:
        """Continuous-aggregate daily OHLCV from market_prices — the
        server-side analog of StorageManager.create_daily_aggregate
        (reference: continuous aggregates, storage.py)."""
        self.db.run_script(
            """
            CREATE MATERIALIZED VIEW IF NOT EXISTS market_prices_daily_ca
            WITH (timescaledb.continuous) AS
            SELECT time_bucket(INTERVAL '1 day', time) AS day,
                   symbol,
                   first(open, time) AS open,
                   MAX(high) AS high,
                   MIN(low) AS low,
                   last(close, time) AS close,
                   SUM(volume) AS volume
            FROM market_prices
            GROUP BY day, symbol
            WITH NO DATA
            """
        )
        self.db.run_execute(
            "CALL refresh_continuous_aggregate('market_prices_daily_ca',"
            " NULL, NULL)")

    def daily_rollup(self, symbol: str) -> List[Dict[str, Any]]:
        return self.db.run_query(
            "SELECT day::text AS day, open, high, low, close, volume"
            " FROM market_prices_daily_ca WHERE symbol = ? ORDER BY day",
            (symbol,),
        )
