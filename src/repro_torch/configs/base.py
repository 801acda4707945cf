"""Configuration dataclasses (``repro/configs/base.py`` counterpart).

``ProtocolConfig`` (the flat Algorithm 1 path), ``TreeProtocolConfig``
(the pytree engine) and the model zoo's ``ModelConfig`` with its
``MoEConfig``/``SSMConfig`` parts, plus the input shapes
``ShapeConfig``/``SHAPES``. Same fields and defaults as the reference, so
``dataclasses.asdict`` of one builds the other
(``repro_torch.interop.config_from_reference``,
``tree_config_from_reference`` and ``model_config_from_reference``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    # expert-parallel layout of the dispatch buffer (a sharding knob of the
    # reference; kept so configs carry across unchanged)
    shard_buffers: bool = False
    # token shards the dispatch sorts within; 1 = global dispatch
    dispatch_shards: int = 1


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64
    n_groups: int = 1
    d_conv: int = 4
    expand: int = 2
    chunk: int = 256
    # heads for the SSD formulation; d_inner = expand*d_model,
    # headdim = d_inner/heads
    headdim: int = 64


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    citation: str = ""
    d_head: Optional[int] = None     # default d_model // n_heads
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid: one shared attention block after every `attn_every` ssm blocks
    attn_every: int = 0
    # xlstm: which layer indices are sLSTM (rest mLSTM)
    slstm_at: Tuple[int, ...] = ()
    sliding_window: int = 0          # 0 = full attention; >0 = window size
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # vlm/audio frontend stubs
    n_patches: int = 0               # vlm: patch embeddings prepended
    n_codebooks: int = 0             # audio: EnCodec codebooks summed at input
    dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return (self.d_head if self.d_head is not None
                else self.d_model // self.n_heads)

    @property
    def attention_free(self) -> bool:
        # xLSTM/Mamba-style: no softmax attention anywhere.
        return self.family == "ssm" and self.attn_every == 0

    def with_sliding_window(self, window: int) -> "ModelConfig":
        return dataclasses.replace(self, sliding_window=window)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: <=2 layers, d_model<=512, <=4 experts."""
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        while n_heads % n_kv:
            n_kv -= 1
        moe = None
        if self.moe is not None:
            moe = MoEConfig(n_experts=4, top_k=min(2, self.moe.top_k),
                            d_ff_expert=128, capacity_factor=2.0)
        ssm = None
        if self.ssm is not None:
            ssm = SSMConfig(d_state=16, n_groups=1, d_conv=4, expand=2,
                            chunk=32, headdim=32)
        return dataclasses.replace(
            self,
            n_layers=2,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            d_head=None,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab=min(self.vocab, 512),
            moe=moe,
            ssm=ssm,
            attn_every=1 if self.attn_every else 0,
            slstm_at=(1,) if self.slstm_at else (),
            n_patches=16 if self.n_patches else 0,
            n_codebooks=self.n_codebooks,
            sliding_window=(min(self.sliding_window, 64)
                            if self.sliding_window else 0),
            dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class Zamba2Config(ModelConfig):
    """Zamba2 as published (arXiv:2411.15242; the port's own, with no
    counterpart in the reference, whose ``zamba2-7b`` is the simplified
    ``ModelConfig``). The stack is ``n_layers`` Mamba2 layers; before the
    Mamba2 layer at each index of ``hybrid_layers`` (insertion j, in
    order) shared block ``j % num_mem_blocks`` reads ``[h ‖ e]`` (the
    hidden state beside the token embedding, 2 d wide): RMS norm,
    attention of ``n_heads`` heads of ``head_dim`` at softmax scale
    ``(head_dim / 2) ** -0.5``, RMS norm, a GELU-gated MLP (exact erf
    GELU) whose ``gate_up`` projection gains insertion j's own
    rank-``adapter_rank`` adapter, then insertion j's ``linear`` (d x d).
    Its output is added to that Mamba2 layer's input and not to the
    residual stream. Each Mamba2 mixer gates its output by ``SiLU(z)``
    and normalises it in ``ssm.n_groups`` groups before ``w_out``, and
    floors its step at ``dt_min``. The output head is the tied
    embedding."""
    hybrid_layers: Tuple[int, ...] = ()
    num_mem_blocks: int = 2
    adapter_rank: int = 128
    dt_min: float = 1e-3             # the floor of softplus(dt + dt_bias)

    def reduced(self) -> "Zamba2Config":
        """Test size in the published form: d 64, Mamba2 at 2 groups of
        state 8, heads of 16, chunk 16; 4 attention heads of 2d / 4 = 32;
        adapter rank 8; six layers with four insertions, so each of the
        two blocks and each adapter's block is used twice; f32."""
        d = 64
        return dataclasses.replace(
            self, n_layers=6, d_model=d, n_heads=4, n_kv_heads=4,
            d_head=2 * d // 4, d_ff=96, vocab=128,
            ssm=SSMConfig(d_state=8, n_groups=2, d_conv=4, expand=2,
                          chunk=16, headdim=16),
            hybrid_layers=(0, 2, 3, 5), adapter_rank=8, dtype="float32")


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k":    ShapeConfig("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeConfig("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeConfig("long_500k",   524_288, 1,   "decode"),
}


@dataclasses.dataclass(frozen=True)
class TreeProtocolConfig:
    """Algorithm 1's five transmissions at model scale (the pytree engine,
    ``core/protocol.py protocol_tree_rounds``). Quasi-Newton state is an
    L-BFGS (s, y) history: 2 * hist parameter copies per machine, never a
    p x p matrix."""
    hist: int = 5                # L-BFGS memory length
    lr: float = 0.5              # center step on aggregated directions
    local_lr: float = 0.1        # R1 machine-local SGD step size
    local_steps: int = 1         # R1 local steps (the local-estimator analog)
    eps: float = 0.0             # TOTAL privacy budget; <= 0 => noiseless
    delta: float = 0.05
    gammas: Tuple[float, ...] = (2.0, 2.0, 2.0, 2.0, 2.0)
    tail: str = "subexp"         # subexp | subgauss (Thm 4.5 vs Lemma 39)
    # Registry aggregator. The MAD-self-calibrated DCQ: the training wire
    # transmits no variance estimates, so the oracle-scale "dcq" of the
    # flat path does not apply.
    aggregator: str = "dcq_mad"
    K: int = 10
    trim_beta: float = 0.2
    # Registry accountant (repro_torch.privacy): how the total (eps, delta)
    # is split over the five transmissions; "basic" is the eps/5 split.
    accountant: str = "basic"


@dataclasses.dataclass(frozen=True)
class ProtocolConfig:
    """Algorithm 1 configuration (paper §4)."""
    K: int = 10                  # composite-quantile levels (paper uses 10)
    eps: float = 30.0            # total privacy budget (split over 5 rounds)
    delta: float = 0.05
    # Algorithm 1's fixed 5 vector rounds; untrusted-center mode adds a
    # sixth DP transmission ("R2b var"), see core/protocol.py
    # transmission_names.
    n_rounds: int = 5
    gammas: Tuple[float, ...] = (2.0, 2.0, 2.0, 2.0, 2.0)  # gamma_1..gamma_5
    # Lower bound on the Hessian eigenvalue (Assumption 7.3). None => each
    # machine calibrates from the eigenvalues of its LOCAL Hessian.
    lambda_s: float | None = None
    tail: str = "subexp"         # subexp | subgauss (Thm 4.5 vs Lemma 39)
    aggregator: str = "dcq"      # dcq | median | trimmed | mean
    trim_beta: float = 0.2       # trimmed-mean fraction
    center_trust: str = "trusted"  # trusted | untrusted (paper §4.3)
    newton_steps: int = 25       # local solver iterations
    noiseless: bool = False      # ablation: no DP noise
    # Composition accountant (repro_torch.privacy registry name); "basic"
    # is the eps/5 (eps/6 untrusted) split.
    accountant: str = "basic"
