"""Launchers.  Port of ``repro.launch``: ``serve`` (``python -m
repro_torch.launch.serve``) and ``train`` (``python -m
repro_torch.launch.train``); the XLA-specific tools (``mesh``, ``cell``,
``dryrun``) are queued in ROADMAP.md §1 (item 12)."""
