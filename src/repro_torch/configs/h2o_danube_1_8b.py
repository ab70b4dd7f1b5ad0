"""Config for --arch h2o-danube-1.8b (see repro_torch.configs.archs for the source dims)."""
from repro_torch.configs.archs import h2o_danube_1_8b, h2o_danube_1_8b_smoke

full = h2o_danube_1_8b
smoke = h2o_danube_1_8b_smoke
