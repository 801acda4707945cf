"""``repro_torch.train`` (``repro.train`` counterpart): the optimizers and
the robust-DP trainer (the AdamW path; the quasi-Newton trainer waits for
ROADMAP A11.4)."""
