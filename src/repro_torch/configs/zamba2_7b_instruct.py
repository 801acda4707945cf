"""Zamba2-7B-Instruct as published [arXiv:2411.15242;
hf:Zyphra/Zamba2-7B-Instruct config.json]: 81 Mamba2 layers (112 heads of
64, state 64, 2 groups, gated group norm, dt floored at
``time_step_min``), and two shared attention blocks that alternate over
the 13 ``hybrid_layer_ids``, each reading [hidden ‖ embedding] (7,168
wide) through 32 heads of 224 at scale (224 / 2) ** -0.5, with a GELU
MLP, a rank-128 adapter and a d x d ``linear`` per insertion; tied
embedding. 7,356,749,648 parameters.

The port's own configuration: the reference's ``zamba2-7b`` is the
simplified block (one shared block after every 6th layer), which stays as
it is in ``ARCHS``."""
from repro_torch.configs.base import SSMConfig, Zamba2Config

CONFIG = Zamba2Config(
    name="zamba2-7b-instruct", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab=32000, d_head=224,
    ssm=SSMConfig(d_state=64, n_groups=2, d_conv=4, expand=2, chunk=256,
                  headdim=64),
    rope_theta=1e4, norm_eps=1e-5, tie_embeddings=True,
    hybrid_layers=(6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77),
    num_mem_blocks=2, adapter_rank=128, dt_min=1e-3,
    citation="arXiv:2411.15242",
)
