"""Device operations (kernels and copies) the profiled passes launched, per
million camera paths they rendered (over several ranks: rank 0's launches
over its share of the paths)."""


def read(r):
    if not r.get("paths_profiled"):
        return None
    return r["launches"] / (r["paths_profiled"] / 1e6)
