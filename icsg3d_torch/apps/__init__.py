"""Command-line apps of the port (python -m icsg3d_torch.apps.<name>)."""
