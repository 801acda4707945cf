"""``repro_torch.sweep`` — the scenario-sweep engine over the paper's
experiment grid (§5), ``repro.sweep`` counterpart.

Declarative grids (``ScenarioGrid``) expand into ``Scenario`` points,
which the executor buckets by the reference's group key and runs on the
device, one ``protocol_rounds`` call per scenario (``TrainScenario``
points, the ``zoo-smoke`` preset, train a reduced model-zoo config with
the pytree engine instead). Results land in the
reference's versioned, resumable JSON artifact (``sweep/artifact.py``),
keyed by the reference's scenario ids.

CLI: ``python -m repro_torch.sweep --preset smoke`` (see ``sweep/cli.py``).
"""
from repro_torch.sweep.artifact import (SCHEMA_VERSION, load, rows, save,
                                        to_csv, validate)
from repro_torch.sweep.executor import SweepExecutor, run_scenarios
from repro_torch.sweep.grid import (Scenario, ScenarioGrid, TrainScenario,
                                    group_label, group_scenarios,
                                    scenario_from_json)
from repro_torch.sweep.presets import (PRESETS, attack_sensitivity_scenarios,
                                       build_preset, fast_variant,
                                       fig_eps_reference, fig_eps_scenarios,
                                       fig_m_scenarios, smoke_scenarios,
                                       table1_scenarios, untrusted_scenarios,
                                       zoo_smoke_scenarios)

__all__ = ["SCHEMA_VERSION", "load", "rows", "save", "to_csv", "validate",
           "SweepExecutor", "run_scenarios",
           "Scenario", "ScenarioGrid", "TrainScenario", "group_label",
           "group_scenarios", "scenario_from_json", "zoo_smoke_scenarios",
           "PRESETS", "attack_sensitivity_scenarios", "build_preset",
           "fast_variant", "fig_eps_reference", "fig_eps_scenarios",
           "fig_m_scenarios", "smoke_scenarios", "table1_scenarios",
           "untrusted_scenarios"]
