"""Training of the port: train state, checkpoints, the DFC-VAE steps and
epoch loop (counterpart of icsg3d_tpu/train, VAE only so far)."""
