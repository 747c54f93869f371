"""engine.tbt_p95_ms: the 95th percentile, in milliseconds, of every gap
between a request's successive tokens, pooled over the requests due in
the window (an unfinished request adds the gap from its last token to
the run's end), as ``tbt_p95_ms`` reads it end to end.  It is read here
where that tail is too unsteady from run to run for a bound: in a
traced run, whose op profiler waits on each chunk and tick."""

import numpy as np


def read(run):
    st = run.stamps
    gaps = []
    for rid in st.due:
        toks = st.tokens[rid]
        gaps.extend(b - a for a, b in zip(toks, toks[1:]))
        if toks and not st.finished(rid):
            gaps.append(run.end_s - toks[-1])
    return float(np.percentile(gaps, 95)) * 1e3 if gaps else None
