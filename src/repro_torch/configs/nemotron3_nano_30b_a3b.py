"""NVIDIA-Nemotron-3-Nano-30B-A3B [hybrid, layer pattern] — 52L d2688
MEMEM*EMEMEM*… (23 Mamba-2, 23 MoE, 6 attention), v131072; Mamba-2 64 heads
of 64, state 128, 8 groups, conv 4 with bias over x, B and C; MoE 128
experts top-6 (sigmoid router, correction bias, normalised, x2.5), relu²
experts of 1,856 and one shared expert of 3,712; GQA 32/2 of 128 without
RoPE.  [hf:nvidia/NVIDIA-Nemotron-3-Nano-30B-A3B-BF16 config.json]

Port-only: the JAX package has no such model, so ``CONFIG`` is not
registered (``registry.ARCHS`` feeds the parity tests against it).  The
benchmark's cell runs a pipeline stage of it with 8 of the 128 experts held
(``portbench/configs/nemotron3-nano-30b-a3b.json``)."""
from repro_torch.models.config import ModelConfig

PATTERN = "MEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEMEM*EMEMEMEME"

CONFIG = ModelConfig(
    name="nemotron3-nano-30b-a3b", family="hybrid",
    n_layers=52, d_model=2688, n_heads=32, n_kv_heads=2, head_dim=128,
    d_ff=1856, vocab=131072, layer_pattern=PATTERN, use_rope=False,
    ssm_state=128, ssm_headdim=64, ssm_nheads=64, ssm_groups=8, ssm_conv=4,
    ssm_conv_bc=True,
    moe_experts=128, moe_topk=6, moe_scale=2.5, moe_shared_ff=3712, norm_eps=1e-5,
)
