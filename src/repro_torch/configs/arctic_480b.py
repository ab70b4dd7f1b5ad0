"""Config for --arch arctic-480b (see repro_torch.configs.archs for the source dims)."""
from repro_torch.configs.archs import arctic_480b, arctic_480b_smoke

full = arctic_480b
smoke = arctic_480b_smoke
