"""The LM zoo's training data (counterpart of `repro.data`)."""
