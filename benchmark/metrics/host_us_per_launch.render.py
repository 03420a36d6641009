"""Host microseconds a device launch, in the pass profiled for the device
alone: that pass's wall less the time the host waited in it for the device
(``blocked_s``: its synchronises and copies, the calls into CUDA that block,
from the profiler's trace), over its launches (device operations).  The
profiler's own cost a launch is in it, the same in every cell.  Over several
ranks: rank 0's."""


def read(r):
    if not r.get("launches") or r.get("blocked_s") is None:
        return None
    return 1e6 * (r["window_s"] - r["blocked_s"]) / r["launches"]
