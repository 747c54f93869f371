"""engine.queue_wait_p50_s: the median, over the requests due in the
window that reached a chunk, of the wall seconds from a request's due
time to the start of its first prefill chunk (the pump's stamps)."""


def read(run):
    st = run.stamps
    waits = [st.first_chunk[r] - st.due[r] for r in st.due
             if r in st.first_chunk]
    if not waits:
        return None
    waits.sort()
    n = len(waits)
    return (waits[(n - 1) // 2] + waits[n // 2]) / 2
