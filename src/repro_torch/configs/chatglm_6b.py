"""chatglm-6b — the paper's evaluation model (Magnus testbed) [arXiv:2103.10360]."""
from repro_torch.configs.base import ModelConfig

# GLM's FFN is a 2-matrix GELU block with inner dim 16384; our dense family
# uses SwiGLU (3 matrices), so d_ff is the parameter-equivalent 2/3 sizing
# (llama convention) to keep the model at its true "6B" scale.
CONFIG = ModelConfig(
    name="chatglm-6b", family="dense", num_layers=28, d_model=4096,
    num_heads=32, num_kv_heads=32, head_dim=128, d_ff=11008,
    vocab_size=130528,
    source="arXiv:2103.10360 (GLM); Magnus paper testbed",
)
