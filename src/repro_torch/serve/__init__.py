"""repro_torch.serve — serving layer (counterpart of :mod:`repro.serve`).

- :mod:`repro_torch.serve.engine`: the LM decode engine with a batched
  slot scheduler.
- :mod:`repro_torch.serve.spectral`: continuous-batching spectral serving.
"""
from .engine import ServeConfig, Engine
from . import spectral
