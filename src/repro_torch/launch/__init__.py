"""Launchers.  Port of ``repro.launch``: ``serve`` (``python -m
repro_torch.launch.serve``), ``train`` (``python -m
repro_torch.launch.train``) and ``mesh``; the XLA-specific tools (``cell``,
``dryrun``) are queued in ROADMAP.md §1 (item 12)."""
