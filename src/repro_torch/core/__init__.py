"""Protocol core of the port (``repro.core`` counterpart).

The protocol's names resolve lazily (PEP 562), so importing a module of
this package (``core.dp``, which ``repro_torch.privacy`` imports) does not
import the protocol and, through it, the privacy registry again."""

_PROTOCOL = ("DPQNProtocol", "ProtocolArrays", "ProtocolResult",
             "ProtocolTreeArrays", "calibrate_sigma_base",
             "monte_carlo_mrse", "n_transmissions", "protocol_rounds",
             "protocol_tree_rounds", "round_budget", "transmission_names")

__all__ = list(_PROTOCOL)


def __getattr__(name):
    if name in _PROTOCOL:
        from repro_torch.core import protocol
        return getattr(protocol, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
