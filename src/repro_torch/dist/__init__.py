"""``repro_torch.dist`` (``repro.dist`` counterpart): the gradient wire
(``grad_agg``) on one device. The multi-device half (``collectives``,
``sharded_protocol``) waits for ROADMAP A10."""
