"""Config for --arch qwen3-1.7b (see repro_torch.configs.archs for the source dims)."""
from repro_torch.configs.archs import qwen3_1_7b, qwen3_1_7b_smoke

full = qwen3_1_7b
smoke = qwen3_1_7b_smoke
