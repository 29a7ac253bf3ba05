"""Networks of the port (counterpart of ``ccvs_tpu/nn``): NHWC, torch-layout
parameters named as in the JAX package."""

from ccvs_tpu_torch.nn.gpt import CGPT, GPT, GPTCore, Schedule, build_schedule

__all__ = ["CGPT", "GPT", "GPTCore", "Schedule", "build_schedule"]
