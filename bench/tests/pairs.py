"""Every configuration file under the traffic files its grid serves: the
cells the harness can run, whether or not ``BENCHMARK.json`` lists them."""

from benchlib.spec import Cell, load_json, load_spec

#: (configuration, traffic) pairs kept as data under ``bench/``.
PAIRS = [("pipe-shared", "chain17-1080p"), ("pipe-shared", "chain3-1080p"),
         ("sobel-5x9", "fleet-1080p")]


def pair(config: str, traffic: str) -> Cell:
    """A configuration under a traffic mix, with the metrics that belong to
    every cell."""
    spec = load_spec()
    return Cell(name=f"{config}/{traffic}", chips=1, config=load_json("configs", config),
                traffic=load_json("workloads", traffic),
                end_to_end=[m for m in spec["end_to_end"] if "workloads" not in m],
                per_layer=[m for m in spec["per_layer"] if "workloads" not in m])
