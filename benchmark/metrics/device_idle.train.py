"""The share of a train step in which no kernel or copy ran on the device,
in %: 1 - (union of the device's intervals in the step profiled for the
device) / (the wall of the unprofiled step before it), as
``device_idle.render`` reads a pass."""


def read(r):
    if r.get("forward_s") is None or not r.get("pass_s"):
        return None
    return 100.0 * (1.0 - r["busy_s"] / r["pass_s"])
