"""Progress + log-file reporting.

Equivalent role to the reference's Progress/ProgressStep/Log/-log
(reference: src/myutils.cpp:1821, SURVEY §5 observability): stderr
progress lines, an optional transcript file with per-stage timings, and
the final "Finished" sentinel the reference's test harness greps for
(test_scripts/check_logs.py).
"""

from __future__ import annotations

import sys
import time
from contextlib import contextmanager

_log_file = None
_quiet = False
_start = time.time()


def configure(log_path: str | None = None, quiet: bool = False) -> None:
    global _log_file, _quiet, _start
    _quiet = quiet
    _start = time.time()
    if log_path:
        _log_file = open(log_path, "w")


def log(fmt: str, *args) -> None:
    msg = fmt % args if args else fmt
    if _log_file:
        _log_file.write(msg + "\n")
        _log_file.flush()


def progress(fmt: str, *args) -> None:
    msg = fmt % args if args else fmt
    if not _quiet:
        sys.stderr.write(msg + "\n")
    log(msg)


_once_seen: set[str] = set()


def log_once(fmt: str, *args) -> None:
    """progress(), but each distinct message is emitted at most once
    per process (for per-dispatch fallback warnings in hot loops)."""
    msg = fmt % args if args else fmt
    if msg not in _once_seen:
        _once_seen.add(msg)
        progress(msg)


# wall seconds per stage name, summed over the process (read by
# chip_smoke.py; clear it to time one run)
STAGE_TIMES: dict[str, float] = {}


@contextmanager
def stage(name: str):
    """Timed pipeline stage; writes elapsed time to the transcript."""
    t0 = time.time()
    try:
        yield
    finally:
        dt = time.time() - t0
        STAGE_TIMES[name] = STAGE_TIMES.get(name, 0.0) + dt
        log("stage %s: %.2fs", name, dt)


def finish() -> None:
    """Write the final elapsed-time line + 'Finished' sentinel."""
    elapsed = time.time() - _start
    progress("Finished (%.1fs elapsed)", elapsed)
    if _log_file:
        _log_file.flush()
