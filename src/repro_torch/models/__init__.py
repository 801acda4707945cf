"""The model zoo (``repro.models`` counterpart): the dense family's decode
(serve) path so far — ``Model.init_cache`` and ``Model.decode_step``."""
