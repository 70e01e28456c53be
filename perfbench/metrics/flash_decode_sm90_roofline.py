"""Kernels: ``flash_decode_sm90``'s share of its roofline over the traced
decode ticks: the least time of its launches (``counts.flash_decode`` at the
ticks' mean cache length, every input byte read once; the count is linear
in the cache length and bound by bytes at every tick's shape, so the mean
length gives the sum over the ticks) over the kernels' card time
(profiler), in percent."""
from perfbench import counts
from perfbench.readout import decode_segment

LAYER = "kernels"
KERNEL = "flash_decode_sm90"


def read(name, r):
    seg, pk = decode_segment(r), r.get("peaks")
    if not seg or pk is None:
        return None
    ops, recs = seg
    mine = [o for o in ops if KERNEL in o[2]]
    spent = sum(o[1] - o[0] for o in mine) / 1e6
    if spent <= 0:
        return None
    c, B = r["ctx"].conf, r["ctx"].traffic["clients"]
    f, b = counts.flash_decode(B, c["num_attention_heads"], c["num_key_value_heads"],
                               c["head_dim"], sum(t["clen"] for t in recs) / len(recs))
    return 100.0 * len(mine) * counts.roofline_s(f, b, pk) / spent
