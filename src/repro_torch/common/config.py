"""Configuration dataclasses (copy of `repro.common.config`).

`ModelConfig` is the single schema wide enough for every architecture
family of the reference package; every field and default is the
reference's, so `dataclasses.asdict` of a port config equals the
reference's. `ShapeConfig`/`SHAPES` describe the workload cells the
admission prior is quoted in; `TrainConfig` is the training run's.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense|moe|ssm|hybrid|encdec|vlm|audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int                       # dense-MLP hidden size (0 for pure-MoE/ssm)
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0               # per-expert hidden size
    moe_layer_period: int = 1       # every k-th layer is MoE (1 = all)
    capacity_factor: float = 1.25

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4

    # --- hybrid (Jamba): attention every k-th layer, SSM otherwise ---
    attn_layer_period: int = 0      # 0 -> attention everywhere (if not ssm)

    # --- encoder-decoder ---
    num_encoder_layers: int = 0

    # --- multimodal frontend stubs ---
    frontend: str = ""              # "" | "vision_stub" | "audio_stub"
    num_prefix_tokens: int = 0      # patch/frame embeddings prepended

    # --- misc ---
    qkv_bias: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    act: str = "swiglu"             # swiglu | gelu
    rope_theta: float = 10000.0
    dtype: str = "bfloat16"
    param_dtype: str = "float32"    # master params
    # provenance (from the assignment table)
    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    # ---- derived ----
    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def is_moe_layer(self, i: int) -> bool:
        if self.num_experts == 0:
            return False
        return (i % self.moe_layer_period) == (self.moe_layer_period - 1)

    def is_attn_layer(self, i: int) -> bool:
        if self.family == "ssm":
            return False
        if self.family == "hybrid" and self.attn_layer_period:
            return (i % self.attn_layer_period) == (self.attn_layer_period - 1)
        return True

    @property
    def has_decoder(self) -> bool:
        return True  # every assigned arch has an autoregressive decoder

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k: attention-free or mostly-SSM hybrid."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (matches models/ init within rounding)."""
        d, v = self.d_model, self.vocab_size
        emb = v * d * (1 if self.tie_embeddings else 2)
        total = emb
        for i in range(self.num_layers):
            total += self._layer_params(i)
        for _ in range(self.num_encoder_layers):
            total += self._enc_layer_params()
        return total

    def active_param_count(self) -> int:
        d, v = self.d_model, self.vocab_size
        total = v * d * (1 if self.tie_embeddings else 2)
        for i in range(self.num_layers):
            total += self._layer_params(i, active_only=True)
        for _ in range(self.num_encoder_layers):
            total += self._enc_layer_params()
        return total

    def _attn_params(self) -> int:
        d, h, kv, hd = self.d_model, self.num_heads, self.num_kv_heads, self.head_dim
        p = d * h * hd + 2 * d * kv * hd + h * hd * d
        if self.qkv_bias:
            p += h * hd + 2 * kv * hd
        return p

    def _mlp_params(self, ff: int) -> int:
        n = 3 if self.act in ("swiglu", "geglu") else 2
        return n * self.d_model * ff

    def _ssm_params(self) -> int:
        d, di = self.d_model, self.d_inner
        # in_proj (x,z,B,C,dt heads), conv, A/D/dt bias, norm, out_proj
        nheads = self.ssm_heads
        proj_in = d * (2 * di + 2 * self.ssm_state + nheads)
        conv = self.conv_width * (di + 2 * self.ssm_state)
        extra = 2 * nheads + di
        return proj_in + conv + extra + di * d

    def _layer_params(self, i: int, active_only: bool = False) -> int:
        p = 2 * self.d_model  # norms
        if self.is_attn_layer(i):
            p += self._attn_params()
        elif self.family in ("ssm", "hybrid"):
            p += self._ssm_params()
        if self.is_moe_layer(i):
            n_exp = self.experts_per_token if active_only else self.num_experts
            p += n_exp * self._mlp_params(self.moe_d_ff)
            p += self.d_model * self.num_experts  # router
        elif self.d_ff:
            p += self._mlp_params(self.d_ff)
        return p

    def _enc_layer_params(self) -> int:
        return 2 * self.d_model + self._attn_params() + self._mlp_params(self.d_ff)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str                       # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


REMAT_MODES = ("none", "block")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The reference's training fields and defaults. `remat` takes "none"
    or "block" (recompute one super-period of layers in the backward).
    `compress_grads` is accepted and, as in the reference, read by no
    step: the reference's train step never calls its
    `optim.compress.compressed_psum`, so the port's does not either (the
    function is ported as `repro_torch.optim.compress`; ROADMAP §C)."""

    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    microbatches: int = 1           # gradient accumulation steps
    remat: str = "block"            # none | block
    compress_grads: bool = False    # int8 cross-pod all-reduce
    seed: int = 0
    checkpoint_every: int = 200
    checkpoint_dir: str = "/tmp/repro_ckpt"
    label_smoothing: float = 0.0

    def __post_init__(self):
        if self.remat not in REMAT_MODES:
            raise ValueError(f"remat {self.remat!r}; expected one of "
                             f"{REMAT_MODES}")
