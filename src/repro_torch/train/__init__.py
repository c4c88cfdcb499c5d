"""Training on PyTorch: AdamW with fp32 master weights, microbatched train
steps, checkpoints and preemption handling (the port of :mod:`repro.train`)."""
