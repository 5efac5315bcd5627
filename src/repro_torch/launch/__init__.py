"""Command-line entry points of the port (``python -m repro_torch.launch.<name>``):
``serve`` and ``train`` (one card), ``mesh`` (the LM meshes) and ``dryrun``
(a per-rank census of each arch x shape x mesh cell on a fake world of
256 or 512 ranks, on ``meta`` tensors, no card needed)."""
