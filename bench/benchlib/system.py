"""The system under test, built from a configuration file.

A configuration names its overlay grid (``grid``), the grid's element type
(``dtype``) and the keyword arguments of the port's serving entry,
``repro_torch.serve.StreamingFrontend`` (``frontend``; empty means its
defaults: ``backend="hopper"``, sync ingest).  This module is the only one
of the harness that imports the port.
"""

from __future__ import annotations

from typing import Optional

#: dtype name -> (data bits, float PE), the port's ``GridSpec`` fields.
DTYPES = {"int32": (32, False), "int16": (16, False),
          "float32": (32, True), "bfloat16": (16, True)}


def itemsize(dtype: str) -> int:
    return DTYPES[dtype][0] // 8


def build_grid(config: dict, dtype: Optional[str] = None):
    """The configuration's grid in ``dtype`` (default: the configuration's).

    ``{"kind": "sobel"}`` is the paper's 18-input 5 x 9 Sobel overlay;
    ``{"kind": "shared", "name", "apps", "num_outputs"}`` is one grid that
    fits every named library app, each level one PE wider than the most any
    of them needs there."""
    from repro_torch.core import applications
    from repro_torch.core import grid as gridlib
    from repro_torch.core.place import level_demand

    bits, float_pe = DTYPES[dtype or config["dtype"]]
    spec = config["grid"]
    if spec["kind"] == "sobel":
        return gridlib.sobel_grid(data_bits=bits, float_pe=float_pe)
    if spec["kind"] == "shared":
        dfgs = [applications.ALL_APPS[n]() for n in spec["apps"]]
        demands = [list(level_demand(g)) for g in dfgs]
        depth = max(len(d) for d in demands)
        demands = [d + [1] * (depth - len(d)) for d in demands]
        widths = [max(d[lvl] for d in demands) + 1 for lvl in range(depth)]
        return gridlib.custom(spec["name"], max(len(g.inputs) for g in dfgs), widths,
                              spec.get("num_outputs", 1), data_bits=bits, float_pe=float_pe)
    raise ValueError(f"unknown grid kind {spec['kind']!r}")


def build_frontend(config: dict, device: str):
    """The port's streaming front end as the configuration states it."""
    from repro_torch.serve import StreamingFrontend

    return StreamingFrontend(device=device, **config.get("frontend", {}))
