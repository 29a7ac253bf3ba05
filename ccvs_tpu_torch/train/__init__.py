"""Trainers of the port (counterpart of ``ccvs_tpu/train``); so far
only what serving shares with them."""
