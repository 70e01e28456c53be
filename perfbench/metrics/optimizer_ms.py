"""Trainer: card milliseconds of the optimizer's update
(``optimizer.apply_updates``), synchronised before and after in the traced
steps and timed by CUDA events on the card, the mean over those steps."""
LAYER = "trainer"


def read(name, r):
    ms = (r.get("seg") or {}).get("optimizer_ms")
    return sum(ms) / len(ms) if ms else None
