"""repro_torch.serve — serving (counterpart of :mod:`repro.serve`): the
spectral server (:mod:`~repro_torch.serve.spectral`).  The LM decode
engine is ROADMAP 'Modules to port' item 14."""
