"""Whole step: model FLOPs of the work completed in the traced run's window
(``counts``: prefills, decode steps at their cache lengths, or training
steps, recompute not counted) over the window's seconds times the card's
bf16 peak (``peaks.json``), in percent (host clock)."""
LAYER = "whole step"


def read(name, r):
    pk = r.get("peaks")
    if pk is None or not r.get("window_flops"):
        return None
    return 100.0 * r["window_flops"] / (r["rec"]["seconds"] * pk["bf16_flop_s"])
