"""Kernels: ``flash_fwd_sm90``'s share of its roofline over the traced
segment: the least time of each launch (``counts.flash_fwd`` at the cell's
prompt or training shape, causal, every input byte read once) over the
kernels' card time (profiler), in percent."""
from perfbench import counts

LAYER = "kernels"
KERNEL = "flash_fwd_sm90"


def read(name, r):
    tr, pk = r.get("trace"), r.get("peaks")
    if tr is None or pk is None:
        return None
    c, t = r["ctx"].conf, r["ctx"].traffic
    B, L = (t["batch"], t["seq"]) if "seq" in t else (1, t["prompt_len"])
    mine = [o for o in tr.ops if KERNEL in o[2]]
    spent = sum(o[1] - o[0] for o in mine) / 1e6
    if not mine or spent <= 0:
        return None
    f, b = counts.flash_fwd(B, c["num_attention_heads"], c["num_key_value_heads"], L, L,
                            c["head_dim"], causal=True)
    return 100.0 * len(mine) * counts.roofline_s(f, b, pk) / spent
