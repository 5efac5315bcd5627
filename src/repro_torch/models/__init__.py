"""The LM zoo's serving stack in PyTorch (twin of the reference's
``models/``): layers, GQA attention with the flash decode kernel (B7) on
the decode path (full and ring caches), MoE, the linear-recurrent mixers,
every block kind, the ``LM`` stack, and the converter from the
reference's parameter pytrees."""

from repro_torch.models.convert import cache_from_numpy, params_from_numpy
from repro_torch.models.lm import LM

__all__ = ["LM", "cache_from_numpy", "params_from_numpy"]
