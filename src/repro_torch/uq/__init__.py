# UQ method namespace; submodules imported directly (repro_torch.uq.mcmc, etc.)
