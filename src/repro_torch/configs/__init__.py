"""Architecture registry of the port. Importing this package registers
every arch of the JAX package's registry, the two frontend archs
(musicgen-medium, internvl2-2b) included; ``get_arch`` of any other
name raises."""
from repro_torch.configs import (  # noqa: F401
    deepseek_moe_16b,
    gemma3_4b,
    grok_1_314b,
    h2o_danube_1_8b,
    internlm2_1_8b,
    internvl2_2b,
    musicgen_medium,
    phi4_mini_3_8b,
    recurrentgemma_2b,
    xlstm_350m,
)
