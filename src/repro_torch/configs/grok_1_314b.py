"""Config for --arch grok-1-314b (see repro_torch.configs.archs for the source dims)."""
from repro_torch.configs.archs import grok_1_314b, grok_1_314b_smoke

full = grok_1_314b
smoke = grok_1_314b_smoke
