"""Config for --arch nemotron-4-15b (see repro_torch.configs.archs for the source dims)."""
from repro_torch.configs.archs import nemotron_4_15b, nemotron_4_15b_smoke

full = nemotron_4_15b
smoke = nemotron_4_15b_smoke
