"""Kernel seam: card milliseconds a step of the kernels launched under
autograd's ``FlashAttentionFnBackward`` node (the attention's backward,
autograd of the plain version), through the profiler's links from each
ATen operation to its kernels, the mean over the traced steps."""
LAYER = "kernel seam"
ATTRIBUTE = "FlashAttentionFnBackward"


def read(name, r):
    tr, seg = r.get("trace"), r.get("seg")
    if tr is None or not seg or not seg.get("steps"):
        return None
    us = tr.attributed.get(ATTRIBUTE, 0.0)
    return us / len(seg["steps"]) / 1e3 if us > 0 else None
