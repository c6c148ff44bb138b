"""Process-aware logging for bobe_tpu_torch.

Only the primary process writes to the console, stdout carries <=INFO and
stderr carries >=WARNING, and every process can optionally write a rotating
per-process log file. Process identity comes from an initialised
``torch.distributed`` group, else the ``RANK`` environment variable.
"""
from __future__ import annotations

import logging
import logging.handlers
import os
import sys

_LEVELS = {
    "DEBUG": logging.DEBUG,
    "INFO": logging.INFO,
    "WARNING": logging.WARNING,
    "ERROR": logging.ERROR,
    "QUIET": logging.CRITICAL,
}

_configured = False


def process_index() -> int:
    """Index of this process in the distributed job (0 if single-process).
    A process that never imported torch has no group (a device-server
    client imports none)."""
    dist = sys.modules.get("torch.distributed")
    if dist is not None and dist.is_available() and dist.is_initialized():
        return int(dist.get_rank())
    return int(os.environ.get("RANK", 0))


def is_main_process() -> bool:
    return process_index() == 0


class _MaxLevelFilter(logging.Filter):
    def __init__(self, max_level):
        super().__init__()
        self.max_level = max_level

    def filter(self, record):
        return record.levelno <= self.max_level


def setup_logging(verbosity: str = "INFO", log_dir: str | None = None) -> None:
    """Configure the root 'bobe_tpu_torch' logger. Safe to call repeatedly."""
    global _configured
    root = logging.getLogger("bobe_tpu_torch")
    level = _LEVELS.get(verbosity.upper(), logging.INFO)
    root.setLevel(level)
    if not _configured:
        root.propagate = False
        if is_main_process():
            out = logging.StreamHandler(sys.stdout)
            out.setLevel(logging.DEBUG)
            out.addFilter(_MaxLevelFilter(logging.INFO))
            err = logging.StreamHandler(sys.stderr)
            err.setLevel(logging.WARNING)
            fmt = logging.Formatter("[%(name)s] %(levelname)s: %(message)s")
            out.setFormatter(fmt)
            err.setFormatter(fmt)
            root.addHandler(out)
            root.addHandler(err)
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            fh = logging.handlers.RotatingFileHandler(
                os.path.join(log_dir,
                             f"bobe_tpu_torch.rank{process_index()}.log"),
                maxBytes=5 * 1024 * 1024,
                backupCount=2,
            )
            fh.setFormatter(logging.Formatter(
                "%(asctime)s [%(name)s] %(levelname)s: %(message)s"))
            root.addHandler(fh)
        _configured = True


def update_verbosity(verbosity: str = "INFO") -> None:
    setup_logging(verbosity)
    logging.getLogger("bobe_tpu_torch").setLevel(
        _LEVELS.get(verbosity.upper(), logging.INFO))


def get_logger(name: str) -> logging.Logger:
    setup_logging()
    return logging.getLogger(f"bobe_tpu_torch.{name}")
