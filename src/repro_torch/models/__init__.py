"""repro_torch.models — config-driven model zoo (counterpart of
:mod:`repro.models`): dicts of tensors, the serving path on the card.
Training (``loss_fn``, the flash backward) is ROADMAP 'Modules to port'
item 14b."""
from .config import ModelConfig
from . import model, layers, moe, ssm, xlstm, cache
