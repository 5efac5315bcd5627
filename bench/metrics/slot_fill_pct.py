"""Slots decoding for a request, over the server's ``max_batch`` (%),
averaged over the ticks that started inside the window."""

#: The system whose run this reader reads (``record.LMRun``).
SYSTEM = "lm"


def read(run):
    ticks = run.window_ticks()
    if not ticks:
        return None
    slots = int(run.config["serve"]["max_batch"])
    return 100.0 * sum(k.active for k in ticks) / (slots * len(ticks))
