"""repro_torch.models — the model stack (counterpart of
:mod:`repro.models`).  Only :mod:`~repro_torch.models.config` is ported so
far; the layers and models are ROADMAP 'Modules to port' item 14."""
