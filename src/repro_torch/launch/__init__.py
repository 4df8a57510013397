"""repro_torch.launch — command-line drivers (counterpart of
:mod:`repro.launch`)."""
