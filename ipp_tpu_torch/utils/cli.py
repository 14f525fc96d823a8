"""Interactive CLI prompts (reference supplements/cli_interface.py:11-79)."""

from __future__ import annotations

from pathlib import Path
from typing import Tuple, Type

from .log import Colors

__all__ = ["ask_for_a_number_in_range", "ask_true_false_question",
           "select_among_options", "ask_for_a_path"]


def ask_for_a_number_in_range(question: str, valid_range: Tuple, dtype: Type):
    while True:
        try:
            value = dtype(input(f"{question} "
                                f"[{valid_range[0]}-{valid_range[1]}]: "))
            if valid_range[0] <= value <= valid_range[1]:
                return value
        except (ValueError, EOFError):
            pass
        print(f"{Colors.WARNING}please enter a {dtype.__name__} in "
              f"{valid_range}{Colors.ENDC}")


def ask_true_false_question(question: str) -> bool:
    while True:
        ans = input(f"{question} [y/n]: ").strip().lower()
        if ans in ("y", "yes", "1", "true"):
            return True
        if ans in ("n", "no", "0", "false"):
            return False


def select_among_options(question: str, options) -> str:
    options = list(options)
    for i, opt in enumerate(options):
        print(f"  {i}: {opt}")
    idx = ask_for_a_number_in_range(question, (0, len(options) - 1), int)
    return options[idx]


def ask_for_a_path(question: str, must_exist: bool = True) -> Path:
    while True:
        p = Path(input(f"{question}: ").strip())
        if not must_exist or p.exists():
            return p
        print(f"{Colors.WARNING}path does not exist{Colors.ENDC}")
