"""Config for --arch mamba2-370m (see repro_torch.configs.archs for the source dims)."""
from repro_torch.configs.archs import mamba2_370m, mamba2_370m_smoke

full = mamba2_370m
smoke = mamba2_370m_smoke
