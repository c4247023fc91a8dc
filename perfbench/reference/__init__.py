"""The plain reference: float32 PyTorch with TF32 off, no kernels, no cache,
no batching.  It imports nothing of the port and takes only what the
benchmark made (weights drawn from the seed, the traffic's tokens) and, to
judge them, the port's outputs."""
