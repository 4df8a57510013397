"""repro_torch.data — the bounded prefetcher and the synthetic LM data
pipeline (counterpart of :mod:`repro.data`)."""
