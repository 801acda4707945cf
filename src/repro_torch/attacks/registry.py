"""Attack registry: one entry per Byzantine wire-corruption rule —
``repro/attacks/registry.py`` counterpart.

An :class:`Attack` bundles the corruption rule ``corrupt(values (m, ...),
mask (m,), factor, key) -> replacement rows`` (dispatch masks them back
onto the Byzantine rows, so honest rows are bit-identical by
construction) with its flags: ``omniscient`` rules read honest-machine
statistics, ``needs_key`` rules draw randomness (``key`` is a
``torch.Generator`` or a pre-drawn standard-normal tensor), and
``round_aware`` rules receive the transmission index.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple


@dataclasses.dataclass(frozen=True)
class Attack:
    """One Byzantine corruption rule over the transmitted machine axis."""
    name: str
    corrupt: Callable
    #: reads honest-machine statistics via (values, mask)
    omniscient: bool = False
    #: draws randomness; apply_attack raises ValueError if key is None
    needs_key: bool = False
    #: receives round_idx (position within Algorithm 1's transmissions)
    round_aware: bool = False
    #: sensible factor sweep values (empty = not in attack-sensitivity)
    factor_grid: Tuple[float, ...] = ()
    doc: str = ""


_REGISTRY: Dict[str, Attack] = {}

#: launcher-friendly aliases (the historical gradient-path names)
ALIASES: Dict[str, str] = {"sign": "signflip", "noise": "gauss"}


def register(attack: Attack) -> Attack:
    """Register (or replace) an attack under ``attack.name``."""
    if attack.name in ALIASES:
        raise ValueError(f"{attack.name!r} shadows alias for "
                         f"{ALIASES[attack.name]!r}")
    _REGISTRY[attack.name] = attack
    return attack


def unregister(name: str) -> None:
    """Remove a registered attack (tests registering temporary entries
    clean up through this instead of the private dict)."""
    _REGISTRY.pop(name, None)


def resolve(name: str) -> str:
    """Canonical registry name for ``name`` (aliases resolved)."""
    return ALIASES.get(name, name)


def get_attack(name: str) -> Attack:
    try:
        return _REGISTRY[resolve(name)]
    except KeyError:
        raise KeyError(f"unknown attack {name!r}; registered: "
                       f"{sorted(_REGISTRY)}") from None


def registered() -> Tuple[str, ...]:
    """Names of all registered attacks, sorted."""
    return tuple(sorted(_REGISTRY))


def needs_key(name: str) -> bool:
    return get_attack(name).needs_key
