"""Launchers.  Port of ``repro.launch``: ``serve`` so far
(``python -m repro_torch.launch.serve``); the training launcher and the
XLA-specific tools (``mesh``, ``cell``, ``dryrun``) are queued in
ROADMAP.md §1 (items 10 and 12)."""
