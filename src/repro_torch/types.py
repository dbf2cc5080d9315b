"""Core configuration dataclasses of the port (copied from ``repro/types.py``).

:class:`ModelConfig` (architecture, with :class:`ClimberConfig` for the
paper's model) and :class:`ShapeConfig` (workload shape) drive the model
and serving code; configs live in ``repro_torch.configs`` as plain
instances.  :class:`TensorSpec` is the port's ``jax.ShapeDtypeStruct``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts settings (None on dense models)."""

    num_experts: int
    top_k: int
    d_ff_expert: int
    # A layer ``i`` is an MoE layer iff ``i % every_n_layers == every_n_layers-1``
    # (jamba: every 2nd layer; kimi/llama4: every layer).
    every_n_layers: int = 1
    capacity_factor: float = 1.25
    num_shared_experts: int = 0
    router_z_loss: float = 1e-3
    load_balance_loss: float = 1e-2


@dataclass(frozen=True)
class ClimberConfig:
    """Paper-specific settings for the Climber GR model (FLAME's workload)."""

    num_blocks: int = 2          # N_b independent transformer blocks
    layers_per_block: int = 12
    num_tasks: int = 3           # multi-task expert head outputs
    num_experts_head: int = 4    # expert MLPs in the top-level head
    adaptive_temperature: bool = True


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description.

    ``layer_pattern`` is a repeating period of layer kinds; entries are
    ``"attn"`` (global attention), ``"swa"`` (sliding window attention),
    ``"mamba"`` or ``"rwkv"``.  ``n_layers`` must be a multiple of the pattern
    length so the stack runs as a loop over pattern groups.
    """

    name: str
    family: str                     # dense | vlm | ssm | audio | moe | hybrid | climber
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // n_heads
    qkv_bias: bool = False
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    activation: str = "swiglu"      # swiglu | gelu | relu
    rope_theta: float = 1e6
    sliding_window: int = 0         # window for "swa" layers (0 = unused)
    layer_pattern: Tuple[str, ...] = ("attn",)
    moe: Optional[MoEConfig] = None
    climber: Optional[ClimberConfig] = None
    # --- encoder-decoder (audio) ---
    enc_dec: bool = False
    n_enc_layers: int = 0
    # --- modality stubs ---
    modality: str = "text"          # text | vision | audio
    frontend_tokens: int = 0        # patch/frame tokens provided by the stub frontend
    # --- long-context eligibility ---
    sub_quadratic: bool = False
    # --- misc ---
    tie_embeddings: bool = True
    dtype: str = "bfloat16"
    source: str = ""                # citation bracket from the assignment
    # --- rwkv specifics ---
    rwkv_head_size: int = 64
    # --- mamba specifics ---
    mamba_d_state: int = 16
    mamba_expand: int = 2
    mamba_d_conv: int = 4

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_layers % len(self.layer_pattern) != 0:
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not a multiple of "
                f"layer_pattern length {len(self.layer_pattern)}")
        if self.moe is not None and len(self.layer_pattern) % self.moe.every_n_layers != 0:
            raise ValueError(f"{self.name}: MoE period must divide layer pattern period")

    @property
    def n_groups(self) -> int:
        return self.n_layers // len(self.layer_pattern)

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    def param_count(self) -> int:
        """Approximate parameter count (used for roofline MODEL_FLOPS)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim
        per_attn = (self.n_heads * hd + 2 * self.n_kv_heads * hd) * d + self.n_heads * hd * d
        n_gate = 2 if self.activation == "swiglu" else 1
        per_dense_ffn = (n_gate + 1) * d * f
        n_attn = sum(1 for k in self.layer_pattern if k in ("attn", "swa")) * self.n_groups
        n_mamba = sum(1 for k in self.layer_pattern if k == "mamba") * self.n_groups
        n_rwkv = sum(1 for k in self.layer_pattern if k == "rwkv") * self.n_groups
        total = v * d  # embedding
        if not self.tie_embeddings:
            total += v * d
        total += n_attn * per_attn
        d_in = self.mamba_expand * d
        total += n_mamba * (2 * d * d_in + d_in * d + d_in * (2 * self.mamba_d_state + 1))
        total += n_rwkv * (4 * d * d + d * d)  # r,k,v,g,o projections approx
        if self.moe is None:
            total += self.n_layers * per_dense_ffn
        else:
            n_moe = self.n_layers // self.moe.every_n_layers
            n_plain = self.n_layers - n_moe
            per_expert = (n_gate + 1) * d * self.moe.d_ff_expert
            total += n_moe * (self.moe.num_experts + self.moe.num_shared_experts) * per_expert
            total += n_moe * d * self.moe.num_experts  # router
            total += n_plain * per_dense_ffn
        if self.enc_dec:
            # decoder cross-attention adds one attention block per decoder layer
            total += self.n_layers * per_attn
        return int(total)


@dataclass(frozen=True)
class ShapeConfig:
    """A workload shape from the assignment (or a paper scenario)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode
    # Climber/SUMI scenarios: candidates scored in parallel per request.
    n_candidates: int = 0

    def __post_init__(self):
        assert self.kind in ("train", "prefill", "decode"), self.kind


@dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype of one tensor (the port's ``jax.ShapeDtypeStruct``)."""

    shape: Tuple[int, ...]
    dtype: object
