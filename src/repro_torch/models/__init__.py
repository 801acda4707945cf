"""The model zoo (``repro.models`` counterpart): the dense, moe, hybrid
and ssm (xLSTM) families, their training forward pass and their decode
(serve) path — ``Model.forward``/``loss``, ``init_cache``, ``decode_step``."""
