"""Launchers.  Port of ``repro.launch``: ``serve`` (``python -m
repro_torch.launch.serve``), ``train`` (``python -m
repro_torch.launch.train``), ``mesh``, and the dry run: ``cell`` (one
rank's step of an (arch x shape x mesh) cell) and ``dryrun`` (``python -m
repro_torch.launch.dryrun``, every cell run at rank 0 on the ``meta``
device)."""
