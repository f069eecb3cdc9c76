"""Layered configuration: defaults <- JSON/YAML file <- PDE_* env vars.

Plain copy of ``pde_tpu/core/config.py`` (host-side Python, no numerics of
its own): the port keeps its own copy because importing any module of
``pde_tpu`` imports JAX.

Mirrors the reference config.py: the dataclass tree (Database / Model /
Trading / Backtest / Logging, :20-112), the precedence rules of load_config
(:237-273, reference env prefix ``QT_``; ours is ``PDE_``) and save/load.
Adds a ComputeConfig for the compute knobs (mesh shape, precision,
quadrature grid) which have no reference counterpart.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "DatabaseConfig",
    "ModelConfig",
    "TradingConfig",
    "BacktestConfig",
    "LoggingConfig",
    "ComputeConfig",
    "Config",
    "load_config",
    "setup_logging",
]

ENV_PREFIX = "PDE"


@dataclass
class DatabaseConfig:
    url: str = "sqlite:///pde_tpu.db"
    pool_size: int = 5
    echo: bool = False

    @property
    def sqlite_path(self) -> str:
        """Path portion of a sqlite URL ('' -> in-memory)."""
        if self.url.startswith("sqlite:///"):
            return self.url[len("sqlite:///"):] or ":memory:"
        if self.url == "sqlite://":
            return ":memory:"
        return self.url


@dataclass
class ModelConfig:
    heston_kappa_bounds: Tuple[float, float] = (0.1, 10.0)
    heston_theta_bounds: Tuple[float, float] = (0.01, 1.0)
    heston_sigma_bounds: Tuple[float, float] = (0.01, 2.0)
    heston_rho_bounds: Tuple[float, float] = (-0.99, 0.99)
    heston_v0_bounds: Tuple[float, float] = (0.01, 1.0)
    sabr_beta: float = 0.5
    sabr_alpha_bounds: Tuple[float, float] = (0.001, 2.0)
    sabr_rho_bounds: Tuple[float, float] = (-0.99, 0.99)
    sabr_nu_bounds: Tuple[float, float] = (0.001, 3.0)
    ou_lookback_days: int = 60
    ou_min_half_life: float = 5.0
    ou_max_half_life: float = 120.0

    def heston_bounds(self) -> Dict[str, Tuple[float, float]]:
        return {
            "kappa": self.heston_kappa_bounds,
            "theta": self.heston_theta_bounds,
            "sigma": self.heston_sigma_bounds,
            "rho": self.heston_rho_bounds,
            "v0": self.heston_v0_bounds,
        }


@dataclass
class TradingConfig:
    initial_capital: float = 100_000.0
    max_position_pct: float = 0.10
    max_portfolio_leverage: float = 1.0
    max_drawdown_pct: float = 0.25
    daily_var_limit: float = 0.02
    stop_loss_pct: float = 0.05
    min_signal_confidence: float = 0.6
    signal_aggregation_method: str = "weighted"
    commission_per_share: float = 0.005
    slippage_bps: float = 5.0
    market_open: str = "09:30"
    market_close: str = "16:00"
    risk_free_rate: float = 0.05
    dividend_yield: float = 0.0


@dataclass
class BacktestConfig:
    start_date: Optional[str] = None
    end_date: Optional[str] = None
    warmup_days: int = 60
    walk_forward_enabled: bool = True
    in_sample_days: int = 252
    out_of_sample_days: int = 63
    monte_carlo_simulations: int = 1000
    bootstrap_method: str = "block"
    block_size: int = 21


@dataclass
class LoggingConfig:
    level: str = "INFO"
    json_format: bool = True
    file: Optional[str] = None
    max_bytes: int = 10_000_000
    backup_count: int = 5


@dataclass
class ComputeConfig:
    """Compute knobs (no reference counterpart)."""

    mesh_shape: Optional[Tuple[int, int]] = None  # (dp, quotes); None = auto
    enable_x64: bool = False  # parity mode (CPU); speed path is f32
    quadrature_points: int = 1024  # reference-parity Carr-Madan grid
    quadrature_du: float = 0.01
    accurate_quadrature_points: int = 8192
    de_popsize: int = 15
    de_maxiter: int = 100


@dataclass
class Config:
    database: DatabaseConfig = field(default_factory=DatabaseConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    trading: TradingConfig = field(default_factory=TradingConfig)
    backtest: BacktestConfig = field(default_factory=BacktestConfig)
    logging: LoggingConfig = field(default_factory=LoggingConfig)
    compute: ComputeConfig = field(default_factory=ComputeConfig)
    env: str = "development"
    debug: bool = False

    # ----------------------------------------------------------- dict/file

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Config":
        cfg = cls()
        for section_name, section in data.items():
            if not hasattr(cfg, section_name):
                continue
            target = getattr(cfg, section_name)
            if dataclasses.is_dataclass(target) and isinstance(section, dict):
                for k, v in section.items():
                    if hasattr(target, k):
                        current = getattr(target, k)
                        if isinstance(current, tuple) and isinstance(v, list):
                            v = tuple(v)
                        setattr(target, k, v)
            else:
                setattr(cfg, section_name, section)
        return cfg

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_file(cls, path: str) -> "Config":
        text = Path(path).read_text()
        if path.endswith((".yml", ".yaml")):
            import yaml

            data = yaml.safe_load(text)
        else:
            data = json.loads(text)
        return cls.from_dict(data or {})

    def save(self, path: str) -> None:
        payload = self.to_dict()
        if path.endswith((".yml", ".yaml")):
            import yaml

            Path(path).write_text(yaml.safe_dump(payload))
        else:
            Path(path).write_text(json.dumps(payload, indent=2))


def _env(name: str) -> Optional[str]:
    return os.getenv(f"{ENV_PREFIX}_{name}")


def load_config(config_file: Optional[str] = None, use_env: bool = True) -> Config:
    """Precedence: defaults <- file <- env vars (config.py:237-273)."""
    config = Config()
    if config_file and Path(config_file).exists():
        config = Config.from_file(config_file)

    if use_env:
        if _env("DATABASE_URL"):
            config.database.url = _env("DATABASE_URL")
        if _env("INITIAL_CAPITAL"):
            config.trading.initial_capital = float(_env("INITIAL_CAPITAL"))
        if _env("MAX_POSITION_PCT"):
            config.trading.max_position_pct = float(_env("MAX_POSITION_PCT"))
        if _env("RISK_FREE_RATE"):
            config.trading.risk_free_rate = float(_env("RISK_FREE_RATE"))
        if _env("ENV"):
            config.env = _env("ENV")
        if _env("DEBUG"):
            config.debug = _env("DEBUG").lower() in ("1", "true", "yes")
        if _env("LOG_LEVEL"):
            config.logging.level = _env("LOG_LEVEL")
        if _env("ENABLE_X64"):
            config.compute.enable_x64 = _env("ENABLE_X64").lower() in ("1", "true", "yes")
    return config


def setup_logging(config: LoggingConfig) -> None:
    from ..monitoring.logging import configure_logging

    configure_logging(
        level=config.level,
        json_format=config.json_format,
        log_file=config.file,
        max_bytes=config.max_bytes,
        backup_count=config.backup_count,
    )
