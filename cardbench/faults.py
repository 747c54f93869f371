"""Faults planted underneath the timed path, each of which ``correct``
has to catch: ``run.run_cell(..., fault=FAULTS[name])`` plants one in
the engine before the window (and undoes what it patched outside the
engine after it).  ``control.py --faults`` reads them on the card at a
cell's own size; the CPU tests at a test's size."""


def state_unchanged(eng):
    """A step that returns its state unchanged: Mamba-2's decode tick
    never absorbs the new SSD state; Yi-9B's chunk KV never lands in its
    pages."""
    if eng.cfg.is_attention_free:
        for d in eng.dstates:
            d.absorb = lambda new, active: None
    else:
        eng.pkv.write_chunk = lambda *a, **k: None


def half_batch(eng):
    """Half of a decode tick's live rows left out: their logits are
    zeroed, so their tokens are the argmax of nothing."""
    import torch

    import repro_torch.serving.engine as E
    fwd = E.forward

    def half(*a, **k):
        lg, aux, caches = fwd(*a, **k)
        if a[5] == "decode":
            live = torch.nonzero(k["cache_len"] > 0)[:, 0]
            lg = lg.clone()
            lg[live[len(live) // 2:]] = 0
        return lg, aux, caches
    E.forward = half

    def undo():
        E.forward = fwd
    return undo


def token_altered(eng):
    """A token altered where it is produced: the first row's token of
    every decode tick is moved to the next vocabulary entry."""
    tick = eng._on_decode_tick

    def altered(now, did):
        rows = list(eng.dstates[did].meta)
        tick(now, did)
        for r in rows[:1]:
            out = eng.outputs[r]
            out[-1] = (out[-1] + 1) % eng.cfg.vocab_size
    eng._on_decode_tick = altered


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "token_altered": token_altered}
