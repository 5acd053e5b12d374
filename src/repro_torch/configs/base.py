"""Architecture config system. One frozen dataclass drives model init,
sharding rules, train/serve steps and the dry-run."""
from __future__ import annotations

import dataclasses


def pad_to(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int                 # 0 for attention-free archs
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    act: str = "swiglu"          # swiglu | geglu | gelu | relu2
    norm: str = "rms"            # rms | rms1p (gemma) | layer
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    attn_softcap: float = 0.0    # grok-style tanh logit capping
    embed_scale: bool = False    # gemma multiplies embeddings by sqrt(d)

    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    moe_a2a_int8: bool = False  # quantize dispatch payload (wire bytes /2)

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4

    # hybrid (zamba2): shared attention blocks interleaved among SSM layers
    shared_attn_every: int = 0   # 0 = no shared blocks
    n_shared_blocks: int = 0

    # modality frontend stubs ([audio]/[vlm] per assignment)
    frontend: str | None = None  # None | "audio_frames" | "vision_patches"
    prefix_len: int = 0          # vlm: number of patch-embedding positions

    # training knobs
    dtype: str = "bfloat16"
    remat: bool = True
    grad_accum: int = 1
    grad_accum_dtype: str = "float32"  # bf16 for the MoE giants (HBM)
    optimizer: str = "adamw"     # adamw | adafactor
    loss_chunk: int = 2048       # sequence chunking for the CE loss

    # ---- derived ----
    @property
    def padded_vocab(self) -> int:
        return pad_to(self.vocab_size, 128)

    @property
    def is_ssm_layer_arch(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def d_inner(self) -> int:  # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def n_params_dense_estimate(self) -> int:
        """Rough parameter count (embeddings + blocks), for roofline N."""
        d = self.d_model
        emb = self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family in ("ssm", "hybrid"):
            di, ns, nh = self.d_inner, self.ssm_state, self.ssm_nheads
            conv_ch = di + 2 * ns
            per_layer = d * (2 * di + 2 * ns + nh) + conv_ch * self.ssm_conv \
                + di * d + 3 * nh + di
        if self.n_heads:
            attn = d * self.n_heads * self.head_dim * 2 \
                + d * self.n_kv_heads * self.head_dim * 2
            if self.family == "hybrid":
                pass  # shared blocks counted separately below
            else:
                per_layer += attn
        if self.family == "moe":
            ff_mults = 3 if self.act in ("swiglu", "geglu") else 2
            per_layer += d * self.moe_d_ff * ff_mults * self.n_experts
            per_layer += d * self.n_experts  # router
        elif self.family != "ssm" and self.d_ff:
            ff_mults = 3 if self.act in ("swiglu", "geglu") else 2
            per_layer += d * self.d_ff * ff_mults
        total = emb + self.n_layers * per_layer
        if self.family == "hybrid" and self.n_shared_blocks:
            attn = d * self.n_heads * self.head_dim * 2 \
                + d * self.n_kv_heads * self.head_dim * 2
            ff_mults = 3 if self.act in ("swiglu", "geglu") else 2
            total += self.n_shared_blocks * (attn + d * self.d_ff * ff_mults)
        return total

    @property
    def n_params_active_estimate(self) -> int:
        """Active params per token (MoE: only routed experts)."""
        if self.family != "moe":
            return self.n_params_dense_estimate
        d = self.d_model
        ff_mults = 3 if self.act in ("swiglu", "geglu") else 2
        dense = self.n_params_dense_estimate - (
            self.n_layers * d * self.moe_d_ff * ff_mults * self.n_experts
        )
        return dense + self.n_layers * d * self.moe_d_ff * ff_mults * self.experts_per_token

    @property
    def n_params_compute_estimate(self) -> int:
        """Params-equivalent per-token compute (hybrid: shared blocks run
        once per super-block, not once per stored copy)."""
        base = self.n_params_active_estimate
        if self.family == "hybrid" and self.n_shared_blocks:
            d = self.d_model
            attn = d * self.n_heads * self.head_dim * 2 \
                + d * self.n_kv_heads * self.head_dim * 2
            ff_mults = 3 if self.act in ("swiglu", "geglu") else 2
            per_block = attn + d * self.d_ff * ff_mults
            n_super = self.n_layers // max(self.shared_attn_every, 1)
            base += per_block * (n_super - self.n_shared_blocks)
        return base


# ---------------------------------------------------------------------------
# Input shapes assigned to the LM family (all 10 archs share these)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

# long_500k needs sub-quadratic sequence mixing (see DESIGN.md shape-skips)
SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


def shapes_for(cfg: ArchConfig) -> list[str]:
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.family in SUBQUADRATIC_FAMILIES:
        out.append("long_500k")
    return out
