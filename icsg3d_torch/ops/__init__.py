"""Device ops of the port: the 3x3x3 conv (and its differentiable form),
the losses, grid transforms, binary atom extraction, and the host
watershed (a verbatim copy)."""
