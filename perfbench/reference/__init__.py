"""Plain PyTorch references of what the timed paths compute (no kernels, no
cache, no batching), which import nothing of the program."""
