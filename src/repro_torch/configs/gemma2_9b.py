"""Config for --arch gemma2-9b (see repro_torch.configs.archs for the source dims)."""
from repro_torch.configs.archs import gemma2_9b, gemma2_9b_smoke

full = gemma2_9b
smoke = gemma2_9b_smoke
