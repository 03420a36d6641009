"""Device operations (kernels and copies) one profiled train step launched:
forward, the checkpointed bounces' recompute, backward and the update."""


def read(r):
    if r.get("forward_s") is None:
        return None
    return float(r["launches"])
