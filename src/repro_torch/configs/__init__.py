"""Architecture registry of the port. Importing this package registers
every ported arch; ``get_arch`` of any other name raises."""
from repro_torch.configs import phi4_mini_3_8b, xlstm_350m  # noqa: F401
