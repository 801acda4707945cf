"""Hand-written CUDA kernels of the model zoo (``repro.kernels``
counterpart): ``gqa_decode``, the GQA flash-decode of the serve path. The
order-statistics kernel of the protocol lives in ``repro_torch.agg``."""
