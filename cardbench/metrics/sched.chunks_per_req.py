"""sched.chunks_per_req: the mean number of prefill chunks the engine ran
for a request due in the window (``eng.chunk_log`` as the pump saw it,
chunks of a restarted prefill counted too)."""


def read(run):
    st = run.stamps
    n = {}
    for rid, *_ in st.chunks:
        if rid in st.due:
            n[rid] = n.get(rid, 0) + 1
    return sum(n.values()) / len(n) if n else None
