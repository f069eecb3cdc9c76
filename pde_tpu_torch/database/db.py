"""Time-series persistence: the TimeSeriesDB facade.

Plain copy of ``pde_tpu/database/db.py`` (host-side Python, no numerics of
its own): the port keeps its own copy because importing any module of
``pde_tpu`` imports JAX.

Mirrors the reference database layer (database/db.py + database/models.py):
market prices, option quotes, model parameters (JSON payloads keyed by
(time, model_type, underlying, maturity) — database/models.py:311), signals,
and the position lifecycle with update trail (:538-897), plus retries and a
health check (:48-146, :922).

Two storage engines behind one facade:

* **sqlite** (default, stdlib) — the test/dev substitution, exactly the
  role SQLite plays in the reference's own test suite (SURVEY.md §4).
  WAL mode + indexed (time, key) columns stand in for hypertables.
* **postgresql / TimescaleDB** — the server-grade production engine the
  reference runs (data/storage.py:86-707, database/db.py:82-146), reached
  by passing a ``postgresql://`` URL (e.g. via ``PDE_DATABASE_URL``).
  Wire access is the in-tree pure-stdlib v3-protocol client
  (:mod:`pde_tpu_torch.database.pgwire`) using the extended query protocol —
  real server-side parameterization, one connection per thread.  On a
  server with the TimescaleDB extension, the time-series tables are
  created as hypertables (best effort; plain PG works too), and the
  JAX package's ``pde_tpu/database/timescale.py`` (not ported) manages
  compression/retention/continuous aggregates.

The facade's SQL is written once in the sqlite dialect; the Postgres
engine translates the three constructs that differ (``?`` placeholders,
``INSERT OR REPLACE`` upserts with the schema's known conflict keys, and
``AUTOINCREMENT``) — a deliberate schema-specific adapter, not a general
translator.
"""

from __future__ import annotations

import json
import re
import sqlite3
import threading
import time as _time
from datetime import datetime, timezone
from typing import Any, Dict, List, Optional, Sequence

__all__ = ["TimeSeriesDB", "retry"]

_SCHEMA = """
CREATE TABLE IF NOT EXISTS market_prices (
    time TEXT NOT NULL,
    symbol TEXT NOT NULL,
    open REAL, high REAL, low REAL, close REAL NOT NULL, volume REAL,
    PRIMARY KEY (time, symbol)
);
CREATE INDEX IF NOT EXISTS idx_prices_symbol_time ON market_prices (symbol, time);

CREATE TABLE IF NOT EXISTS option_quotes (
    time TEXT NOT NULL,
    underlying TEXT NOT NULL,
    strike REAL NOT NULL,
    expiration TEXT NOT NULL,
    option_type TEXT NOT NULL,
    bid REAL, ask REAL, last REAL, volume INTEGER, open_interest INTEGER,
    implied_vol REAL,
    PRIMARY KEY (time, underlying, strike, expiration, option_type)
);
CREATE INDEX IF NOT EXISTS idx_options_underlying ON option_quotes (underlying, time);

CREATE TABLE IF NOT EXISTS model_parameters (
    time TEXT NOT NULL,
    model_type TEXT NOT NULL,
    underlying TEXT NOT NULL,
    maturity REAL,
    parameters TEXT NOT NULL,
    fit_quality TEXT,
    converged INTEGER NOT NULL DEFAULT 1,
    calibration_time_ms INTEGER
);
CREATE INDEX IF NOT EXISTS idx_params_lookup
    ON model_parameters (model_type, underlying, time);

CREATE TABLE IF NOT EXISTS signals (
    time TEXT NOT NULL,
    asset TEXT NOT NULL,
    strategy TEXT NOT NULL,
    signal_type TEXT NOT NULL,
    confidence REAL,
    payload TEXT
);
CREATE INDEX IF NOT EXISTS idx_signals_asset ON signals (asset, time);

CREATE TABLE IF NOT EXISTS positions (
    position_id INTEGER PRIMARY KEY AUTOINCREMENT,
    symbol TEXT NOT NULL,
    direction TEXT NOT NULL,
    quantity REAL NOT NULL,
    entry_price REAL NOT NULL,
    entry_time TEXT NOT NULL,
    exit_price REAL,
    exit_time TEXT,
    status TEXT NOT NULL DEFAULT 'open',
    strategy TEXT,
    metadata TEXT
);

CREATE TABLE IF NOT EXISTS position_updates (
    position_id INTEGER NOT NULL,
    time TEXT NOT NULL,
    price REAL NOT NULL,
    unrealized_pnl REAL,
    note TEXT
);
"""

# conflict keys for the facade's INSERT OR REPLACE statements — the PG
# engine rewrites them as ON CONFLICT ... DO UPDATE (we own this schema)
_UPSERT_KEYS = {
    "market_prices": ("time", "symbol"),
    "option_quotes": ("time", "underlying", "strike", "expiration",
                      "option_type"),
    "market_prices_daily": ("day", "symbol"),
    "equity_curve": ("time",),
}

# time-series tables to convert to hypertables when Timescale is present
_HYPERTABLES = ("market_prices", "option_quotes", "model_parameters",
                "signals", "position_updates")


def _pg_transient(exc) -> bool:
    """Is this PgError worth a retry?  Connection trouble (class 08),
    serialization/deadlock (40001/40P01), and server-starting (57P03)."""
    code = getattr(exc, "code", "")
    return code.startswith("08") or code in ("40001", "40P01", "57P03")


def retry(n_attempts: int = 3, delay: float = 0.05):
    """Retry-with-backoff decorator (database/db.py:48-81).  Retries
    sqlite lock contention, dropped connections, and transient PG errors
    (the engine reconnects on the next attempt)."""

    def wrap(fn):
        def inner(*args, **kwargs):
            from .pgwire import PgError

            last = None
            for attempt in range(n_attempts):
                try:
                    return fn(*args, **kwargs)
                except sqlite3.OperationalError as exc:  # lock contention etc.
                    last = exc
                except (ConnectionError, OSError) as exc:
                    last = exc
                    _invalidate(args)
                except PgError as exc:
                    if not _pg_transient(exc):
                        raise
                    last = exc
                    _invalidate(args)
                _time.sleep(delay * (2**attempt))
            raise last

        return inner

    return wrap


def _invalidate(args) -> None:
    eng = getattr(args[0], "_engine", None) if args else None
    if eng is not None and hasattr(eng, "invalidate"):
        eng.invalidate()


def _iso(ts) -> str:
    if isinstance(ts, str):
        return ts
    if isinstance(ts, datetime):
        return ts.isoformat()
    return datetime.now(timezone.utc).isoformat()


# ---------------------------------------------------------------------------
# engines


class _SqliteEngine:
    """Stdlib sqlite3: one connection per thread, WAL journal."""

    name = "sqlite3"

    def __init__(self, path: str):
        self.path = path
        self._local = threading.local()
        # for :memory:, every connection is a separate database; share one
        self._shared = (sqlite3.connect(path, check_same_thread=False)
                        if path == ":memory:" else None)
        self.lock = threading.Lock()
        with self._conn() as con:
            con.executescript(_SCHEMA)
            if path != ":memory:":
                con.execute("PRAGMA journal_mode=WAL")

    def _conn(self) -> sqlite3.Connection:
        if self._shared is not None:
            return self._shared
        con = getattr(self._local, "con", None)
        if con is None:
            con = sqlite3.connect(self.path)
            con.row_factory = sqlite3.Row
            self._local.con = con
        return con

    def query(self, sql: str, params: Sequence[Any] = ()) -> List[Dict[str, Any]]:
        con = self._conn()
        con.row_factory = sqlite3.Row
        return [dict(r) for r in con.execute(sql, tuple(params)).fetchall()]

    def execute(self, sql: str, params: Sequence[Any] = (),
                returning: Optional[str] = None):
        with self.lock, self._conn() as con:
            cur = con.execute(sql, tuple(params))
            return int(cur.lastrowid) if returning else None

    def executemany(self, sql: str, rows: Sequence[Sequence[Any]]) -> None:
        with self.lock, self._conn() as con:
            con.executemany(sql, rows)

    def executescript(self, sql: str) -> None:
        with self.lock:
            self._conn().executescript(sql)

    def ping(self) -> None:
        self._conn().execute("SELECT 1").fetchone()

    def backup(self, dest_path: str) -> int:
        src = self._conn()
        src.execute("PRAGMA wal_checkpoint(TRUNCATE)")
        with self.lock:
            dst = sqlite3.connect(dest_path)
            try:
                src.backup(dst)
                return dst.execute(
                    "SELECT COUNT(*) FROM sqlite_master WHERE type='table'"
                ).fetchone()[0]
            finally:
                dst.close()

    def restore(self, src_path: str) -> int:
        src = sqlite3.connect(src_path)
        try:
            with self.lock:
                dst = self._conn()
                src.backup(dst)
                return dst.execute(
                    "SELECT COUNT(*) FROM sqlite_master WHERE type='table'"
                ).fetchone()[0]
        finally:
            src.close()

    def close(self) -> None:
        if self._shared is not None:
            self._shared.close()
        con = getattr(self._local, "con", None)
        if con is not None:
            con.close()


_QMARK = re.compile(r"\?")


class _PostgresEngine:
    """PostgreSQL/TimescaleDB over :mod:`pde_tpu_torch.database.pgwire`.

    One wire connection per thread (the client is not multiplexed);
    ``invalidate()`` drops the calling thread's connection so a retry
    reconnects.  The schema is created on first connect; when the
    TimescaleDB extension is available the time-series tables become
    hypertables (best effort — plain PG serves the same facade).
    """

    name = "postgresql"

    def __init__(self, url: str):
        from .pgwire import parse_pg_url

        self._kwargs = parse_pg_url(url)
        self.path = self._redacted(url)
        self._local = threading.local()
        self.lock = threading.Lock()
        self.timescale = False
        self._init_schema()

    @staticmethod
    def _redacted(url: str) -> str:
        return re.sub(r"(://[^:/@]+):[^@]*@", r"\1:***@", url)

    # ------------------------------------------------------------ plumbing

    def _conn(self):
        from .pgwire import PgConnection

        con = getattr(self._local, "con", None)
        if con is None:
            con = PgConnection(**self._kwargs)
            self._local.con = con
        return con

    def invalidate(self) -> None:
        con = getattr(self._local, "con", None)
        if con is not None:
            try:
                con.close()
            except Exception:  # noqa: BLE001
                pass
            self._local.con = None

    # ---------------------------------------------------------- translation

    def _translate(self, sql: str) -> str:
        """sqlite-dialect -> PG for the constructs this schema uses."""
        m = re.match(r"\s*INSERT OR REPLACE INTO\s+(\w+)", sql, re.I)
        if m:
            table = m.group(1).lower()
            keys = _UPSERT_KEYS.get(table)
            if keys is None:
                raise ValueError(f"no upsert keys known for table {table}")
            sql = re.sub(r"INSERT OR REPLACE", "INSERT", sql, count=1,
                         flags=re.I)
            cols = re.search(r"\(([^)]*)\)\s*VALUES", sql, re.I | re.S)
            col_names = [c.strip() for c in cols.group(1).split(",")]
            updates = ", ".join(
                f"{c} = EXCLUDED.{c}" for c in col_names if c not in keys)
            conflict = f" ON CONFLICT ({', '.join(keys)}) "
            conflict += f"DO UPDATE SET {updates}" if updates else "DO NOTHING"
            sql = sql.rstrip().rstrip(";") + conflict
        # positional placeholders: ? -> $1..$n
        n = 0

        def sub(_):
            nonlocal n
            n += 1
            return f"${n}"

        return _QMARK.sub(sub, sql)

    @staticmethod
    def _script_pg(sql: str) -> str:
        """DDL dialect fixes: serial keys, real timestamps (hypertables
        need a timestamp-typed time column), and 8-byte floats (sqlite
        REAL is 8-byte; PG REAL would silently drop to float4)."""
        sql = sql.replace("INTEGER PRIMARY KEY AUTOINCREMENT",
                          "BIGSERIAL PRIMARY KEY")
        sql = re.sub(r"\b(time|entry_time|exit_time|day) TEXT\b",
                     r"\1 TIMESTAMPTZ", sql)
        return re.sub(r"\bREAL\b", "DOUBLE PRECISION", sql)

    def _init_schema(self) -> None:
        from .pgwire import PgError

        con = self._conn()
        con.execute_script(self._script_pg(_SCHEMA))
        try:
            con.execute_script("CREATE EXTENSION IF NOT EXISTS timescaledb")
        except PgError:
            pass  # no extension / no privilege: plain PG is fine
        try:
            cols, rows = con.execute(
                "SELECT COUNT(*) FROM pg_extension WHERE extname = $1",
                ("timescaledb",))
            self.timescale = bool(rows and rows[0][0])
        except PgError:
            self.timescale = False
        if self.timescale:
            for table in _HYPERTABLES:
                try:
                    con.execute(
                        "SELECT create_hypertable($1, 'time',"
                        " if_not_exists => TRUE,"
                        " migrate_data => TRUE)", (table,))
                except PgError:
                    pass  # e.g. unsupported layout — table stays plain

    # ------------------------------------------------------------- surface

    def query(self, sql: str, params: Sequence[Any] = ()) -> List[Dict[str, Any]]:
        with self.lock:
            cols, rows = self._conn().execute(self._translate(sql),
                                              tuple(params))
        return [dict(zip(cols, r)) for r in rows]

    def execute(self, sql: str, params: Sequence[Any] = (),
                returning: Optional[str] = None):
        sql_t = self._translate(sql)
        if returning:
            sql_t = f"{sql_t.rstrip().rstrip(';')} RETURNING {returning}"
        with self.lock:
            _, rows = self._conn().execute(sql_t, tuple(params))
        return rows[0][0] if returning else None

    def executemany(self, sql: str, rows: Sequence[Sequence[Any]]) -> None:
        """Batch insert in ONE transaction (per-row autocommit would pay
        a WAL flush per row — the difference between bulk ingest and a
        trickle on a hypertable)."""
        sql_t = self._translate(sql)
        with self.lock:
            con = self._conn()
            con.execute("BEGIN")
            try:
                for r in rows:
                    con.execute(sql_t, tuple(r))
                con.execute("COMMIT")
            except Exception:
                try:
                    con.execute("ROLLBACK")
                except Exception:  # noqa: BLE001
                    pass
                raise

    def executescript(self, sql: str) -> None:
        with self.lock:
            self._conn().execute_script(self._script_pg(sql))

    def ping(self) -> None:
        with self.lock:
            self._conn().execute("SELECT 1")

    def backup(self, dest_path: str) -> int:
        raise RuntimeError(
            "online backup of a server database is an ops concern: use "
            "pg_dump / pg_basebackup (deploy/scripts/backup.sh does for "
            "the sqlite engine what your DBA tooling does here)")

    restore = backup

    def close(self) -> None:
        self.invalidate()


# ---------------------------------------------------------------------------
# facade


class TimeSeriesDB:
    """Facade over the persistence layer (database/db.py:82-950).

    Thread-safe: one connection per thread on either engine.  Pass a
    sqlite path / ``sqlite://`` URL for the embedded engine, or a
    ``postgresql://`` URL for the server engine.
    """

    def __init__(self, path: str = ":memory:"):
        if re.match(r"(postgresql|postgres|timescaledb)://", path):
            self._engine = _PostgresEngine(path)
        else:
            self._engine = _SqliteEngine(self._normalize_path(path))
        self.path = self._engine.path

    @property
    def _lock(self):
        """Engine write lock (legacy admin paths: migrations, storage)."""
        return self._engine.lock

    def _conn(self):
        """Raw sqlite connection — sqlite engine only.  Server-engine
        admin goes through the JAX package's
        ``pde_tpu/database/timescale.py`` (not ported) or the
        engine-neutral ``run_script``/``run_query`` methods."""
        if not isinstance(self._engine, _SqliteEngine):
            raise RuntimeError(
                "raw connections are sqlite-only; use run_query/run_script "
                "or database.timescale for server-side administration")
        return self._engine._conn()

    @staticmethod
    def _normalize_path(path: str) -> str:
        """Accept a filesystem path or a sqlite URL (reference db.py:82-146
        takes SQLAlchemy URLs).  ``sqlite:`` / ``sqlite://`` map to
        ``:memory:``; ``sqlite:///rel`` and ``sqlite:////abs`` strip to the
        file path.  Any other URL scheme is rejected instead of silently
        creating a file literally named after the URL."""
        if path.startswith("sqlite:"):
            rest = path[len("sqlite:"):].lstrip("/") if path not in ("sqlite:", "sqlite://") else ""
            if path.startswith("sqlite:////"):
                rest = "/" + rest
            return rest or ":memory:"
        if "://" in path:
            raise ValueError(
                "TimeSeriesDB takes a sqlite path/URL or a postgresql:// "
                f"URL, got {path!r}"
            )
        return path

    @property
    def engine_name(self) -> str:
        return self._engine.name

    @property
    def is_timescale(self) -> bool:
        return bool(getattr(self._engine, "timescale", False))

    # engine-neutral admin surface (migrations, ops tooling)

    def run_query(self, sql: str, params: Sequence[Any] = ()) -> List[Dict[str, Any]]:
        return self._engine.query(sql, params)

    def run_execute(self, sql: str, params: Sequence[Any] = ()) -> None:
        self._engine.execute(sql, params)

    def run_script(self, sql: str) -> None:
        self._engine.executescript(sql)

    # ------------------------------------------------------------- prices

    @retry()
    def insert_market_prices(self, rows: List[Dict[str, Any]]) -> int:
        self._engine.executemany(
            "INSERT OR REPLACE INTO market_prices (time, symbol, open, high, low, close, volume)"
            " VALUES (?, ?, ?, ?, ?, ?, ?)",
            [
                (
                    _iso(r["time"]), r["symbol"], r.get("open"), r.get("high"),
                    r.get("low"), r["close"], r.get("volume"),
                )
                for r in rows
            ],
        )
        return len(rows)

    @retry()
    def query_market_prices(
        self, symbol: str, start: Optional[str] = None, end: Optional[str] = None
    ) -> List[Dict[str, Any]]:
        q = "SELECT * FROM market_prices WHERE symbol = ?"
        args: List[Any] = [symbol]
        if start:
            q += " AND time >= ?"
            args.append(_iso(start))
        if end:
            q += " AND time <= ?"
            args.append(_iso(end))
        q += " ORDER BY time"
        return self._engine.query(q, args)

    # ------------------------------------------------------------- options

    @retry()
    def insert_option_quotes(self, rows: List[Dict[str, Any]]) -> int:
        self._engine.executemany(
            "INSERT OR REPLACE INTO option_quotes"
            " (time, underlying, strike, expiration, option_type, bid, ask, last,"
            "  volume, open_interest, implied_vol)"
            " VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
            [
                (
                    _iso(r["time"]), r["underlying"], r["strike"], str(r["expiration"]),
                    r["option_type"], r.get("bid"), r.get("ask"), r.get("last"),
                    r.get("volume"), r.get("open_interest"), r.get("implied_vol"),
                )
                for r in rows
            ],
        )
        return len(rows)

    @retry()
    def query_option_chain(self, underlying: str, time: Optional[str] = None) -> List[Dict[str, Any]]:
        if time is None:
            rows = self._engine.query(
                "SELECT MAX(time) AS t FROM option_quotes WHERE underlying = ?",
                (underlying,),
            )
            time = rows[0]["t"] if rows else None
            if time is None:
                return []
        return self._engine.query(
            "SELECT * FROM option_quotes WHERE underlying = ? AND time = ?"
            " ORDER BY expiration, strike",
            (underlying, _iso(time)),
        )

    # --------------------------------------------------------- model params

    @retry()
    def store_model_parameters(
        self,
        model_type: str,
        underlying: str,
        parameters: Dict[str, Any],
        fit_quality: Optional[Dict[str, Any]] = None,
        maturity: Optional[float] = None,
        converged: bool = True,
        calibration_time_ms: Optional[int] = None,
        time: Optional[datetime] = None,
    ) -> None:
        """Parameter store keyed like database/models.py:311."""
        self._engine.execute(
            "INSERT INTO model_parameters"
            " (time, model_type, underlying, maturity, parameters, fit_quality,"
            "  converged, calibration_time_ms) VALUES (?, ?, ?, ?, ?, ?, ?, ?)",
            (
                _iso(time), model_type, underlying, maturity,
                json.dumps(parameters), json.dumps(fit_quality or {}),
                int(converged), calibration_time_ms,
            ),
        )

    @retry()
    def get_latest_model_parameters(
        self, model_type: str, underlying: str, maturity: Optional[float] = None
    ) -> Optional[Dict[str, Any]]:
        q = (
            "SELECT * FROM model_parameters WHERE model_type = ? AND underlying = ?"
            + (" AND maturity IS NULL" if maturity is None else " AND maturity = ?")
            + " ORDER BY time DESC LIMIT 1"
        )
        args = [model_type, underlying] + ([] if maturity is None else [maturity])
        rows = self._engine.query(q, args)
        if not rows:
            return None
        row = rows[0]
        return {
            "time": row["time"],
            "model_type": row["model_type"],
            "underlying": row["underlying"],
            "maturity": row["maturity"],
            "parameters": json.loads(row["parameters"]),
            "fit_quality": json.loads(row["fit_quality"] or "{}"),
            "converged": bool(row["converged"]),
            "calibration_time_ms": row["calibration_time_ms"],
        }

    @retry()
    def get_parameter_history(
        self, model_type: str, underlying: str, limit: int = 100
    ) -> List[Dict[str, Any]]:
        rows = self._engine.query(
            "SELECT * FROM model_parameters WHERE model_type = ? AND underlying = ?"
            " ORDER BY time DESC LIMIT ?",
            (model_type, underlying, limit),
        )
        return [
            {**r, "parameters": json.loads(r["parameters"]),
             "fit_quality": json.loads(r["fit_quality"] or "{}")}
            for r in rows
        ]

    # ------------------------------------------------------------- signals

    @retry()
    def store_signal(
        self, asset: str, strategy: str, signal_type: str,
        confidence: float = 0.0, payload: Optional[Dict] = None,
        time: Optional[datetime] = None,
    ) -> None:
        self._engine.execute(
            "INSERT INTO signals (time, asset, strategy, signal_type, confidence, payload)"
            " VALUES (?, ?, ?, ?, ?, ?)",
            (_iso(time), asset, strategy, signal_type, confidence, json.dumps(payload or {})),
        )

    @retry()
    def query_signals(self, asset: Optional[str] = None, limit: int = 100) -> List[Dict[str, Any]]:
        if asset:
            rows = self._engine.query(
                "SELECT * FROM signals WHERE asset = ? ORDER BY time DESC LIMIT ?",
                (asset, limit),
            )
        else:
            rows = self._engine.query(
                "SELECT * FROM signals ORDER BY time DESC LIMIT ?", (limit,)
            )
        return [{**r, "payload": json.loads(r["payload"] or "{}")} for r in rows]

    # ------------------------------------------------------------ positions

    @retry()
    def open_position(
        self, symbol: str, direction: str, quantity: float, entry_price: float,
        strategy: Optional[str] = None, entry_time: Optional[datetime] = None,
        metadata: Optional[Dict] = None,
    ) -> int:
        return int(self._engine.execute(
            "INSERT INTO positions (symbol, direction, quantity, entry_price,"
            " entry_time, status, strategy, metadata) VALUES (?, ?, ?, ?, ?, 'open', ?, ?)",
            (symbol, direction, quantity, entry_price, _iso(entry_time), strategy,
             json.dumps(metadata or {})),
            returning="position_id",
        ))

    @retry()
    def update_position(
        self, position_id: int, price: float, unrealized_pnl: Optional[float] = None,
        note: str = "", time: Optional[datetime] = None,
    ) -> None:
        self._engine.execute(
            "INSERT INTO position_updates (position_id, time, price, unrealized_pnl, note)"
            " VALUES (?, ?, ?, ?, ?)",
            (position_id, _iso(time), price, unrealized_pnl, note),
        )

    @retry()
    def close_position(
        self, position_id: int, exit_price: float, exit_time: Optional[datetime] = None
    ) -> None:
        self._engine.execute(
            "UPDATE positions SET exit_price = ?, exit_time = ?, status = 'closed'"
            " WHERE position_id = ?",
            (exit_price, _iso(exit_time), position_id),
        )

    @retry()
    def get_open_positions(self) -> List[Dict[str, Any]]:
        return self._engine.query("SELECT * FROM positions WHERE status = 'open'")

    @retry()
    def get_position_history(self, position_id: int) -> List[Dict[str, Any]]:
        return self._engine.query(
            "SELECT * FROM position_updates WHERE position_id = ? ORDER BY time",
            (position_id,),
        )

    # -------------------------------------------------------------- health

    def health_check(self) -> Dict[str, Any]:
        """Liveness probe (database/db.py:922-950)."""
        try:
            t0 = _time.perf_counter()
            self._engine.ping()
            out = {
                "healthy": True,
                "latency_ms": (_time.perf_counter() - t0) * 1000.0,
                "engine": self._engine.name,
                "path": self.path,
            }
            if self.is_timescale:
                out["timescaledb"] = True
            return out
        except Exception as exc:  # noqa: BLE001
            return {"healthy": False, "error": str(exc)}

    # ------------------------------------------------------- backup/restore

    def backup(self, dest_path: str) -> Dict[str, Any]:
        """Online backup to ``dest_path`` via sqlite's backup API.

        Mirrors the reference's ops-level backup posture
        (deploy/scripts/backup.sh, WAL archiving + pg_dump): a WAL
        checkpoint followed by a consistent point-in-time copy, safe to run
        while readers/writers are active.  The server engine raises — its
        backups belong to pg_dump/pg_basebackup, as in the reference.
        """
        n_tables = self._engine.backup(dest_path)
        return {"path": dest_path, "tables": n_tables,
                "time": datetime.now(timezone.utc).isoformat()}

    def restore(self, src_path: str) -> Dict[str, Any]:
        """Replace this database's contents from a backup file
        (reference docs/DATABASE_RECOVERY.md posture; SURVEY.md §5)."""
        n = self._engine.restore(src_path)
        return {"restored_from": src_path, "tables": n}

    def close(self) -> None:
        self._engine.close()
