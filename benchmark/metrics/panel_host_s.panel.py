"""Host seconds a job spends in the program's panel/reweight and
panel/resample spans: the reweight's LML call and reads back, the
per-series ESS, index math and gather.  None on a CPU run, where the
LML is computed inside the span."""

from ._shared import span_mean


def read(ctx):
    if ctx["device"] == "cpu":
        return None
    parts = [span_mean(ctx, s) for s in ("panel/reweight", "panel/resample")]
    if all(p is None for p in parts):
        return None
    return sum(p or 0.0 for p in parts)
