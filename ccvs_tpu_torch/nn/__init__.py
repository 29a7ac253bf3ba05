"""Networks of the port (counterpart of ``ccvs_tpu/nn``): NHWC, torch-layout
parameters named as in the JAX package."""
