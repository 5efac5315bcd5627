"""The LM zoo in PyTorch (twin of the reference's ``models/``): layers,
GQA attention with the flash decode kernel (B7) on the decode path (full
and ring caches), MoE, the linear-recurrent mixers, every block kind, the
``LM`` stack (training loss, prefill, decode), and the converters from the
reference's parameter, cache and optimizer-state pytrees."""

from repro_torch.models.convert import cache_from_numpy, opt_state_from_numpy, params_from_numpy
from repro_torch.models.lm import LM

__all__ = ["LM", "cache_from_numpy", "opt_state_from_numpy", "params_from_numpy"]
