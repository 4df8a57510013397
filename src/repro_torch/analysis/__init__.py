"""repro_torch.analysis: the roofline model over dry-run records and their
comparison (counterpart of :mod:`repro.analysis`)."""
