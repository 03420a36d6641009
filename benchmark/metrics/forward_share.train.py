"""One forward-only ``render_loss`` on the step's batch (no gradient) over
the wall of one train step, both unprofiled and synchronised, in %."""


def read(r):
    if r.get("forward_s") is None or not r.get("pass_s"):
        return None
    return 100.0 * r["forward_s"] / r["pass_s"]
