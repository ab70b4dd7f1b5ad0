"""Config for --arch llava-next-mistral-7b (see repro_torch.configs.archs for the source dims)."""
from repro_torch.configs.archs import llava_next_mistral_7b, llava_next_mistral_7b_smoke

full = llava_next_mistral_7b
smoke = llava_next_mistral_7b_smoke
