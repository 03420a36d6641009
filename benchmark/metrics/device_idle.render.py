"""The share of a pass in which no kernel or copy ran on the device, in %:
1 - (union of the device's intervals in the pass profiled for the device)
/ (the wall of the unprofiled pass before it).  The profiler slows every
launch on the host, so the profiled pass's own wall would overstate the
idle share of a run that is not traced (the traced run's ``busy_s`` over
``window_s`` reads that overstated share)."""


def read(r):
    if not r.get("pass_s"):
        return None
    return 100.0 * (1.0 - r["busy_s"] / r["pass_s"])
