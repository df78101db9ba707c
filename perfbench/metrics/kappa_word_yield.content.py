"""``kappa_word_yield.content``: the share of the kappa Newton's word
slots spent on words still being solved, in one EM iteration recorded by
the program with ``trace.recording()``: 100 x ``kappa.word_steps`` (the
words not yet done at each chunk step) / ``kappa.slot_steps`` (the chunk
width at each step).  Done words riding along to their chunk's slowest
one are the waste.  None for a program that keeps no such counters."""


def read(ctx):
    rec = ctx.get("record")
    if rec is None:
        return None
    c = rec.resolve().counters
    slots, words = c.get("kappa.slot_steps"), c.get("kappa.word_steps")
    if not slots or words is None:
        return None
    return 100.0 * words / slots
