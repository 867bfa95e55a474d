"""Optimizer of the LM zoo's training (counterpart of `repro.optim`)."""
