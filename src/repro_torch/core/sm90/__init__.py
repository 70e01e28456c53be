"""SimFA-H100: the Sim-FA models of the port's own bf16 kernels on an H100 SXM.

The Hopper counterpart of the JAX package's ``core/tpu/`` (SimFA-TPU):
``machine`` (the H100 preset and the kernels' constants), ``analytical`` (the
paper's §3 traffic method at the kernels' tiling), ``tracegen`` (engine traces
of ``csrc/flash_fwd_sm90.cu`` and ``csrc/flash_decode_sm90.cu`` as they run)
and ``autotune`` (the kernels' ``stages`` and ``n_split`` picked by the model).
"""
