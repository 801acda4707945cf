"""``repro_torch.launch`` — the port's launchers (``repro.launch``
counterpart): ``python -m repro_torch.launch.serve`` so far; the training
and dry-run launchers wait for the model-zoo training slice."""
