"""The gradient's share of a train step recorded with spans on, in %: the
program's ``train.backward`` span (autograd's backward and the bounces it
recomputes, up to the device's end) over its ``train.step`` span."""


def read(r):
    spans = (r.get("trace") or {}).get("spans", {})
    if not spans.get("train.step", {}).get("total_s") or "train.backward" not in spans:
        return None
    return 100.0 * spans["train.backward"]["total_s"] / spans["train.step"]["total_s"]
