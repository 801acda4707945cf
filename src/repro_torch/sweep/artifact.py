"""Versioned sweep artifact: JSON on disk, one record per scenario —
``repro/sweep/artifact.py`` counterpart, the same schema, so the two
packages' artifacts diff per scenario id.

Schema (version 3)::

    {
      "schema_version": 3,
      "kind": "repro.sweep",
      "meta": {"torch": ..., "device": ..., "n_devices": ...,
               "preset": ...},
      "grid": {...} | null,             # originating ScenarioGrid, if any
      "scenarios": {
        "<scenario_id>": {
          "scenario": {<Scenario fields>},
          "metrics":  {"mrse_cq": .., "mrse_os": .., "mrse_qn": ..}
                      | {"accuracy": ..},
          "spend":    {"eps_total": .., "delta_total": ..,
                       "n_transmissions": .., "eps_per_round": ..,
                       "sigmas": [..], "accountant": ..,
                       "sigma_ratio_vs_basic": ..,
                       "failure_probs": [..] | absent,
                       "per_leaf": [..] | absent},
          "comm":     {"bytes_per_machine": .., "bytes_per_round": ..,
                       "n_transmissions": .., "eps_per_round": ..,
                       "newton_bytes_per_machine": ..,
                       "gd20_bytes_per_machine": ..},
          "thetas_qn": [[..p floats..] x reps] | null,
          "timing":   {"group": <label>, "group_seconds": ..,
                       "group_size": .., "chunk": .., "n_chunks": ..,
                       "launches": ..}
        }, ...
      }
    }

v2 added the "comm" record (sweep/comm.py): transmission cost and
per-round budget ride the same versioned artifact as MRSE. v3 added
privacy accounting to the spend record: the privacy registry's
accountant that certified the per-round budget, its noise ratio vs basic
composition, and the high-probability failure ledger. Older artifacts
fail validation, so a resume against one restarts cleanly instead of
mixing schemas.

Artifacts are written atomically (tmp + rename) after EVERY group
chunk, so an interrupted sweep resumes from the completed scenarios
(``load_done_ids``). ``to_csv`` flattens the records for plotting.
"""
from __future__ import annotations

import csv
import json
import os
import tempfile
from typing import Dict, Iterable, List, Optional, Set

SCHEMA_VERSION = 3
KIND = "repro.sweep"

_REQUIRED_RECORD_KEYS = ("scenario", "metrics", "spend", "comm", "timing")
_REQUIRED_SPEND_KEYS = ("eps_total", "delta_total", "n_transmissions",
                        "sigmas", "accountant")
_REQUIRED_COMM_KEYS = ("bytes_per_machine", "bytes_per_round",
                       "n_transmissions")


def new_artifact(meta: Optional[Dict] = None,
                 grid: Optional[Dict] = None) -> Dict:
    return {"schema_version": SCHEMA_VERSION, "kind": KIND,
            "meta": dict(meta or {}), "grid": grid, "scenarios": {}}


def validate(artifact: Dict) -> None:
    """Raise ValueError on any schema violation (tested round-trip)."""
    if not isinstance(artifact, dict):
        raise ValueError("artifact must be a JSON object")
    if artifact.get("kind") != KIND:
        raise ValueError(f"artifact kind {artifact.get('kind')!r} != {KIND!r}")
    version = artifact.get("schema_version")
    if version != SCHEMA_VERSION:
        raise ValueError(f"schema_version {version!r} unsupported "
                         f"(expected {SCHEMA_VERSION})")
    scen = artifact.get("scenarios")
    if not isinstance(scen, dict):
        raise ValueError("artifact.scenarios must be an object")
    for sid, rec in scen.items():
        for key in _REQUIRED_RECORD_KEYS:
            if key not in rec:
                raise ValueError(f"scenario {sid!r} missing {key!r}")
        if not isinstance(rec["metrics"], dict) or not rec["metrics"]:
            raise ValueError(f"scenario {sid!r} has empty metrics")
        for key in _REQUIRED_SPEND_KEYS:
            if key not in rec["spend"]:
                raise ValueError(f"scenario {sid!r} spend missing {key!r}")
        for key in _REQUIRED_COMM_KEYS:
            if key not in rec["comm"]:
                raise ValueError(f"scenario {sid!r} comm missing {key!r}")


def save(artifact: Dict, path: str) -> None:
    """Atomic write: partial artifacts on disk are always schema-valid."""
    validate(artifact)
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(artifact, f, indent=1, sort_keys=False)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load(path: str) -> Dict:
    with open(path) as f:
        artifact = json.load(f)
    validate(artifact)
    return artifact


def load_done_ids(path: str) -> Set[str]:
    """Scenario ids already completed in a partial artifact; empty set when
    the file is missing or unreadable/invalid (sweep restarts cleanly)."""
    if not os.path.exists(path):
        return set()
    try:
        return set(load(path)["scenarios"].keys())
    except (ValueError, json.JSONDecodeError, OSError):
        return set()


def rows(artifact: Dict) -> List[Dict]:
    """Flatten to one plain dict per scenario (CSV/pandas-friendly)."""
    out = []
    for sid, rec in artifact["scenarios"].items():
        row: Dict = {"scenario_id": sid}
        for key, val in rec["scenario"].items():
            if isinstance(val, (list, tuple)):
                val = "x".join(str(v) for v in val)
            row[key] = val
        row.update(rec["metrics"])
        row["eps_total"] = rec["spend"]["eps_total"]
        row["delta_total"] = rec["spend"]["delta_total"]
        row["n_transmissions"] = rec["spend"]["n_transmissions"]
        row["accountant"] = rec["spend"].get(
            "accountant", rec["scenario"].get("accountant", "basic"))
        row["sigma_ratio_vs_basic"] = rec["spend"].get(
            "sigma_ratio_vs_basic", 1.0)
        row["bytes_per_machine"] = rec["comm"]["bytes_per_machine"]
        row["bytes_per_round"] = rec["comm"]["bytes_per_round"]
        row["group"] = rec["timing"]["group"]
        row["group_seconds"] = rec["timing"]["group_seconds"]
        out.append(row)
    return out


def to_csv(artifact: Dict, path: str) -> None:
    flat = rows(artifact)
    if not flat:
        raise ValueError("artifact has no scenarios to export")
    fields: List[str] = []
    for row in flat:              # union of keys, first-seen order
        for key in row:
            if key not in fields:
                fields.append(key)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=fields)
        writer.writeheader()
        writer.writerows(flat)


def merge(base: Dict, other: Dict) -> Dict:
    """Union two artifacts (other wins on id collisions); meta from base."""
    validate(base)
    validate(other)
    out = new_artifact(meta=base["meta"], grid=base.get("grid"))
    out["scenarios"] = dict(base["scenarios"])
    out["scenarios"].update(other["scenarios"])
    return out


def get_metric(artifact: Dict, scenario_id: str, name: str) -> float:
    return artifact["scenarios"][scenario_id]["metrics"][name]


def thetas_qn(artifact: Dict, scenario_id: str) -> Iterable:
    t = artifact["scenarios"][scenario_id].get("thetas_qn")
    if t is None:
        raise KeyError(f"scenario {scenario_id!r} stored no thetas")
    return t
