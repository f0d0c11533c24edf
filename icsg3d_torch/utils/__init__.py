"""Utility subsystems of the port: wall-clock timeouts (a verbatim copy) and
profiling (``utils.profiling``: traces, step timers, FLOP counts)."""

from icsg3d_torch.utils.timeout import TimeoutError_, run_with_timeout

__all__ = ["TimeoutError_", "run_with_timeout"]
