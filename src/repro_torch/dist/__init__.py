"""``repro_torch.dist`` (``repro.dist`` counterpart): the paper's robust
DP aggregation as infrastructure, in three layers.

  * ``grad_agg``          — per-machine DP noise, Byzantine corruption and
                            robust aggregation over a leading machine axis
                            (the trainer's gradient wire);
  * ``collectives``       — the machine axis spread over
                            ``torch.distributed`` ranks: the rows gathered
                            in machine order, then the same aggregation;
  * ``sharded_protocol``  — Algorithm 1 and the tree engine with each
                            rank computing its own machines, the center's
                            math replicated on every rank.
"""
from repro_torch.dist.grad_agg import (GradAggConfig, add_dp_noise,
                                       aggregate_machine_axis,
                                       corrupt_machines, robust_aggregate)
from repro_torch.dist.collectives import sharded_aggregate_leaf
from repro_torch.dist.sharded_protocol import run_sharded

__all__ = ["GradAggConfig", "add_dp_noise", "aggregate_machine_axis",
           "corrupt_machines", "robust_aggregate",
           "sharded_aggregate_leaf", "run_sharded"]
