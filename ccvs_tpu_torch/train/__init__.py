"""Trainers of the port (counterpart of ``ccvs_tpu/train``): the frame
autoencoder with its discriminators, the latent transformer and the state
estimator on a frozen autoencoder, and the STFT audio autoencoder."""
