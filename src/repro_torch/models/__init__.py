"""repro_torch.models — config-driven model zoo (counterpart of
:mod:`repro.models`): dicts of tensors, the serving path and the training
path (``loss_fn``, the flash backward) on the card."""
from .config import ModelConfig
from . import model, layers, moe, ssm, xlstm, cache
