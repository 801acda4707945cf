"""Protocol core of the port (``repro.core`` counterpart).

Every name resolves lazily (PEP 562), so importing a module of this
package (``core.dp``, which ``repro_torch.privacy`` imports) does not
import the protocol and, through it, the privacy registry again."""
import importlib

_PROTOCOL = ("DPQNProtocol", "ProtocolArrays", "ProtocolResult",
             "ProtocolTreeArrays", "calibrate_sigma_base",
             "monte_carlo_mrse", "n_transmissions", "protocol_rounds",
             "protocol_tree_rounds", "round_budget", "transmission_names")
_DCQ = ("dcq", "dcq_with_sigma", "d_k", "are_dcq", "ARE_MEDIAN")
_LOSSES = ("get_problem", "PROBLEMS")
_SUBMODULES = ("dp", "bfgs", "local", "baselines", "transport")

__all__ = [*_DCQ, *_PROTOCOL, *_LOSSES, *_SUBMODULES]


def __getattr__(name):
    if name in _PROTOCOL:
        from repro_torch.core import protocol
        return getattr(protocol, name)
    if name in _DCQ:
        from repro_torch.agg import reference
        return getattr(reference, name)
    if name in _LOSSES:
        from repro_torch.core import losses
        return getattr(losses, name)
    if name in _SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
