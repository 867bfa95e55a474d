"""repro_torch.analysis — the race detector's named-lock factories
(`races.named_lock` and friends), which the fabric stack imports."""
