"""Leveled stderr logging + decode progress.

The PyTorch port's copy of ld_decode_tpu/utils/log.py (the port imports
nothing of the JAX package).  The reference's observability surface: the
Qt message handler with Debug/Info/Warning/Critical levels and -d/-q
CLI flags (reference app/tbc/main.cpp:43-79,105-110) and the percent
progress report in the TBC execute loop (reference tbc.cpp:366-370).
The active Python pipeline only had bare prints (lddecode.py:92); this
module gives every CLI one shared, levelled channel.

Kept dependency-free and global-state-minimal on purpose: decode runs
are single-process per CLI invocation (like the reference), and tests
drive the level explicitly.
"""

from __future__ import annotations

import os
import sys

DEBUG, INFO, WARNING, CRITICAL = 10, 20, 30, 40
_NAMES = {DEBUG: 'Debug', INFO: 'Info', WARNING: 'Warning',
          CRITICAL: 'Critical'}

_level = INFO
_last_pct = -1


def set_level(level: int) -> None:
    global _level, _last_pct
    _level = level
    _last_pct = -1


def get_level() -> int:
    return _level


def configure_from_flags(quiet: bool = False, debug: bool = False) -> None:
    """-q wins over -d, like the reference's flag handling
    (main.cpp:105-110 checks quiet first)."""
    set_level(WARNING if quiet else DEBUG if debug else INFO)
    env = os.environ.get('LDD_LOG', '').upper()
    if env in ('DEBUG', 'INFO', 'WARNING', 'CRITICAL'):
        set_level(globals()[env])


def _emit(level: int, msg: str) -> None:
    if level >= _level:
        print(f'{_NAMES[level]}: {msg}', file=sys.stderr)


def debug(msg: str) -> None:
    _emit(DEBUG, msg)


def info(msg: str) -> None:
    _emit(INFO, msg)


def warning(msg: str) -> None:
    _emit(WARNING, msg)


def critical(msg: str) -> None:
    _emit(CRITICAL, msg)


def progress(done: float, total: float, what: str = 'decoded') -> None:
    """Whole-percent progress line, printed only on change
    (reference tbc.cpp:366-370 prints percentage through the input)."""
    global _last_pct
    if total <= 0:
        return
    pct = min(100, int(100.0 * done / total))
    if pct != _last_pct:
        _last_pct = pct
        _emit(INFO, f'{pct}% {what}')
