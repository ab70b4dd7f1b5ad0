"""Config for --arch hymba-1.5b (see repro_torch.configs.archs for the source dims)."""
from repro_torch.configs.archs import hymba_1_5b, hymba_1_5b_smoke

full = hymba_1_5b
smoke = hymba_1_5b_smoke
