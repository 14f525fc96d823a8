"""Logging: console tee with ANSI colors stripped in the file copy
(reference p_log, process_images.py:67-86; PrintColors,
supplements/cli_interface.py:67-79)."""

from __future__ import annotations

import re
import time
from pathlib import Path
from typing import Optional

__all__ = ["Colors", "Logger", "date_time_now"]

_ANSI_RE = re.compile(r"\x1b\[[0-9;]*m")


class Colors:
    HEADER = "\033[95m"
    BLUE = "\033[94m"
    GREEN = "\033[92m"
    WARNING = "\033[93m"
    FAIL = "\033[91m"
    ENDC = "\033[0m"


def date_time_now() -> str:
    return time.strftime("%Y-%m-%d %H:%M:%S")


class Logger:
    """Tee to console and a log file (ANSI stripped in the file)."""

    def __init__(self, log_file: Optional[Path] = None):
        self.log_file = Path(log_file) if log_file else None
        if self.log_file:
            self.log_file.parent.mkdir(parents=True, exist_ok=True)

    def __call__(self, msg: str) -> None:
        print(msg, flush=True)
        if self.log_file:
            with open(self.log_file, "a") as f:
                f.write(_ANSI_RE.sub("", msg) + "\n")

    def warn(self, msg: str) -> None:
        self(f"{Colors.WARNING}{msg}{Colors.ENDC}")

    def error(self, msg: str) -> None:
        self(f"{Colors.FAIL}{msg}{Colors.ENDC}")

    def info(self, msg: str) -> None:
        self(f"{Colors.GREEN}{date_time_now()}: {Colors.ENDC}{msg}")
