"""Training on one card: optimizers, the train step, the synthetic data
stream, checkpoints and the fault-tolerant loop (``repro.train``'s port)."""
