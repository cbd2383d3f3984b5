"""Architecture configs ported so far (one module per arch, as in repro.configs)."""
