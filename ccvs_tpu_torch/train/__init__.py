"""Trainers of the port (counterpart of ``ccvs_tpu/train``): the latent
stage, the transformer trainer and the state-estimator trainer, on a frozen
autoencoder."""
