"""``repro_torch.launch`` — the port's launchers (``repro.launch``
counterpart): ``python -m repro_torch.launch.serve``,
``python -m repro_torch.launch.train`` and the dry run
``python -m repro_torch.launch.dryrun``, which traces one rank's step on
the meta device against the H100 machine model of ``launch.mesh`` and
``launch.roofline``."""
