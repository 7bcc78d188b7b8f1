"""ctypes binding to the native system-metrics sampler
(``native/sysmon.cpp``, built at first use by ``_build.host_library``),
with the pure-Python /proc reader when ``CRT_DISABLE_NATIVE`` is set.
Mirrors the reference's sysinfo usage: global CPU% + process RSS sampled
per frame (performance.rs:66-81)."""

from __future__ import annotations

import ctypes
import os

_LIB = None
_last_cpu = None


def _load():
    """The loaded library (built first if needed), or None when
    ``CRT_DISABLE_NATIVE`` asks for the Python reader."""
    global _LIB
    if _LIB is not None or os.environ.get("CRT_DISABLE_NATIVE"):
        return _LIB
    from compute_renderer_torch import _build

    lib = ctypes.CDLL(str(_build.host_library("sysmon")))
    lib.crt_global_cpu_percent.restype = ctypes.c_double
    lib.crt_global_cpu_percent.argtypes = []
    lib.crt_process_rss_bytes.restype = ctypes.c_int64
    lib.crt_process_rss_bytes.argtypes = []
    _LIB = lib
    return _LIB


def global_cpu_percent() -> float:
    """Global CPU usage % since the previous call (0.0 on first call)."""
    lib = _load()
    if lib is not None:
        return float(lib.crt_global_cpu_percent())
    return _py_cpu_percent()


def process_rss_bytes() -> int:
    lib = _load()
    if lib is not None:
        return int(lib.crt_process_rss_bytes())
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return 0


def _py_cpu_percent() -> float:
    global _last_cpu
    try:
        with open("/proc/stat") as f:
            fields = f.readline().split()[1:]
        vals = [int(x) for x in fields]
        total = sum(vals)
        idle = vals[3] + (vals[4] if len(vals) > 4 else 0)
    except (OSError, ValueError, IndexError):
        return 0.0
    pct = 0.0
    if _last_cpu is not None and total > _last_cpu[0]:
        dt = total - _last_cpu[0]
        didle = idle - _last_cpu[1]
        pct = 100.0 * (dt - didle) / dt
    _last_cpu = (total, idle)
    return pct
