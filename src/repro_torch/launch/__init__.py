"""``repro_torch.launch`` — the port's launchers (``repro.launch``
counterpart): ``python -m repro_torch.launch.serve`` and
``python -m repro_torch.launch.train``; the dry-run and roofline
launchers wait for ROADMAP A12."""
