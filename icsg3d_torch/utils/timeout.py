# Verbatim copy of icsg3d_tpu/utils/timeout.py.
"""Wall-clock timeouts for host-side preprocessing steps.

The reference guarded pathological CIF parses and voxelizations with
func_timeout (utils.py:97,147; create_matrices.py:115,156).  This is the
dependency-free equivalent: SIGALRM-based on the main thread, with a
thread-based fallback elsewhere (the thread variant cannot interrupt C
extensions mid-call; it bounds the wait, not the work).
"""

from __future__ import annotations

import signal
import threading
from typing import Any, Callable


class TimeoutError_(BaseException):
    """Raised when a guarded call exceeds its wall-clock budget.

    Derives from BaseException (like func_timeout's FunctionTimedOut) so
    a guarded fn's internal ``except Exception`` retry loop cannot
    swallow the timeout — the one-shot timer would never re-arm and the
    budget this module exists to enforce would be silently void.
    """


def _run_with_alarm(fn, seconds, args, kwargs):
    done = []

    def handler(signum, frame):
        if done:
            # the alarm fired in the window between fn returning and the
            # disarm — the call DID finish in budget; a raise here would
            # discard a successfully computed result
            return
        raise TimeoutError_(f"call exceeded {seconds}s")

    old_handler = signal.signal(signal.SIGALRM, handler)
    old_timer = signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        out = fn(*args, **kwargs)
        done.append(True)
        return out
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old_handler)
        # restore an outer timer (nested run_with_timeout, an application
        # watchdog): setitimer returned its remaining (delay, interval),
        # which unconditional disarming used to discard
        if old_timer[0] > 0:
            remaining = max(old_timer[0] - seconds, 0.001)
            signal.setitimer(signal.ITIMER_REAL, remaining, old_timer[1])


def _run_with_thread(fn, seconds, args, kwargs):
    result: list = []
    error: list = []

    def target():
        try:
            result.append(fn(*args, **kwargs))
        except BaseException as e:  # surface the real exception —
            # anything narrower left both lists empty and crashed the
            # caller with IndexError instead
            error.append(e)

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(seconds)
    if t.is_alive():
        raise TimeoutError_(f"call exceeded {seconds}s")
    if error:
        raise error[0]
    return result[0]


def run_with_timeout(
    fn: Callable, seconds: float, *args: Any, **kwargs: Any
) -> Any:
    """Run fn(*args, **kwargs) with a wall-clock limit; raises TimeoutError_.

    seconds <= 0 times out immediately (a remaining-budget computation
    that reaches zero must not silently DISABLE the guard, which is what
    setitimer(0) would do).
    """
    if seconds <= 0:
        raise TimeoutError_(f"no budget left ({seconds}s)")
    if threading.current_thread() is threading.main_thread():
        return _run_with_alarm(fn, seconds, args, kwargs)
    return _run_with_thread(fn, seconds, args, kwargs)
