"""Config for --arch seamless-m4t-large-v2 (see repro_torch.configs.archs for the source dims)."""
from repro_torch.configs.archs import seamless_m4t_large_v2, seamless_m4t_large_v2_smoke

full = seamless_m4t_large_v2
smoke = seamless_m4t_large_v2_smoke
