"""Data pipelines of the port: copies of ``repro.data`` (numpy only)."""
from repro_torch.data.babi import BabiTask, generate_babi, make_task
from repro_torch.data.synthetic import SyntheticLM, make_lm_batch

__all__ = ["SyntheticLM", "make_lm_batch", "BabiTask", "generate_babi",
           "make_task"]
