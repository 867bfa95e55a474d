"""Entry points of the LM zoo's training (counterpart of `repro.launch`)."""
