"""Architecture registry of the port. Importing this package registers
every ported arch (the JAX package's token-prompt archs); ``get_arch``
of any other name raises."""
from repro_torch.configs import (  # noqa: F401
    deepseek_moe_16b,
    gemma3_4b,
    grok_1_314b,
    h2o_danube_1_8b,
    internlm2_1_8b,
    phi4_mini_3_8b,
    recurrentgemma_2b,
    xlstm_350m,
)
