"""Seconds that the first pass of a run costs over a later one: set-up's
warm pass (a train cell: its first checked step) less the pass (step)
recorded with spans on in the window, both the program's own ``frame``
(``train.step``) span.  What the first use adds: the kernel libraries'
loads or builds, the device's lazy module loads, the allocator's growth.
A difference of two single passes, so it carries both passes' spread."""


def read(r):
    first = (r.get("setup_trace") or {}).get("spans", {})
    later = (r.get("trace") or {}).get("spans", {})
    for name in ("train.step", "frame"):
        if name in first and name in later:
            return first[name]["first_s"] - later[name]["first_s"]
    return None
