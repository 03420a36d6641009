"""The share of the wavefront's lanes still alive at the start of each
bounce, over the bounces of the pass recorded with spans on, in %: the
program's counters ``bounce.live`` over ``bounce.lanes``.  Over several
ranks: rank 0's."""


def read(r):
    counters = (r.get("trace") or {}).get("counters", {})
    if not counters.get("bounce.lanes"):
        return None
    return 100.0 * counters["bounce.live"] / counters["bounce.lanes"]
