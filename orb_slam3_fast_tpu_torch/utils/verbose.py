"""Leveled logging -- ORB-SLAM3's ``Verbose`` class
(``include/System.h:47-72``), copied from ``orb_slam3_fast_tpu/utils/verbose.py``
(stdlib only; the JAX package's import would pull in jax): a process-wide verbosity
threshold and ``print_mess(msg, level)`` that prints only when the message
level is at or below it.  Default QUIET like the reference (System.cc:272).
"""
from __future__ import annotations

import sys

VERBOSITY_QUIET = 0
VERBOSITY_NORMAL = 1
VERBOSITY_VERBOSE = 2
VERBOSITY_VERY_VERBOSE = 3
VERBOSITY_DEBUG = 4

_level = VERBOSITY_QUIET


def set_verbosity(level: int):
    """Verbose::SetTh."""
    global _level
    _level = int(level)


def get_verbosity() -> int:
    return _level


def print_mess(msg: str, level: int = VERBOSITY_NORMAL):
    """Verbose::PrintMess: emit ``msg`` iff ``level`` <= current threshold."""
    if level <= _level:
        print(msg, file=sys.stderr, flush=True)


_cap_hits: dict = {}


def warn_cap(tag: str, kept: int, total: int, level: int = VERBOSITY_NORMAL):
    """One-line warning whenever a fixed capacity truncates real work
    (SURVEY "no silent caps" rule).  Throttled per call-site tag: the first
    hit always prints, then every 100th, with a running total."""
    n = _cap_hits.get(tag, 0) + 1
    _cap_hits[tag] = n
    if n == 1 or n % 100 == 0:
        print_mess(
            f"[cap] {tag}: kept {kept}/{total} ({n} hits so far)", level
        )
