"""The model zoo (``repro.models`` counterpart): the dense, moe, hybrid
and ssm (xLSTM) families, their training forward pass and their decode
(serve) path — ``Model.forward``/``loss``, ``init_cache``, ``decode_step``.

``Model`` and the submodules resolve lazily (PEP 562), so importing one
module of the package (``models.sharding``, which ``dist`` imports) does
not build the whole zoo."""
import importlib

_SUBMODULES = ("attention", "blocks", "flash", "layers", "moe", "sharding",
               "ssm", "xlstm")

__all__ = ["Model", *_SUBMODULES]


def __getattr__(name):
    if name == "Model":
        from repro_torch.models.model import Model
        return Model
    if name in _SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
