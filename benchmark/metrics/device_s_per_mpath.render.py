"""Seconds the device was busy (union of its kernel and copy intervals) in
the pass profiled for the device, per million camera paths of that pass: the
device's work, which the host's pace does not move (a steadier companion of
``paths_per_s``, whose cells are paced by the host's launches)."""


def read(r):
    if not r.get("paths_profiled") or r.get("busy_s") is None:
        return None
    return r["busy_s"] / (r["paths_profiled"] / 1e6)
