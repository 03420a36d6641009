"""The slowest rank's render over the ranks' mean, in the pass recorded with
spans on: each rank's ``rank_render`` span (its own share of the frame, up
to its device's end, before the gather), the largest over their mean;
nothing in a cell of one process."""


def read(r):
    secs = [t["spans"]["rank_render"]["total_s"] for t in r.get("ranks_trace") or []
            if "rank_render" in t["spans"]]
    if len(secs) < 2:
        return None
    return max(secs) / (sum(secs) / len(secs))
