"""The traversal kernels' share of their bound, in %: the least time the
kept calls (a fixed few closest and any-hit calls of the first profiled
pass) could take on the card, counted from their inputs by
``harness/work.py``, over the device time their kernels took."""


def read(r):
    calls = r.get("traversal_calls") or []
    dev = sum(c["device_s"] for c in calls)
    if dev <= 0:
        return None
    return 100.0 * sum(c["bound_s"] for c in calls) / dev
