"""Hand-written CUDA kernels for Hopper (``csrc/``), their ctypes bindings,
plain PyTorch versions (:mod:`.ref`) and the dispatching wrappers
(:mod:`.ops`)."""
