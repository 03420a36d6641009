"""The traversal kernels' (``sp_closest``, ``sp_anyhit``) device time over
all the device's busy time in the profiled passes, in %."""


def read(r):
    if not r.get("busy_s"):
        return None
    return 100.0 * (sum(r["closest_s"]) + sum(r["anyhit_s"])) / r["busy_s"]
