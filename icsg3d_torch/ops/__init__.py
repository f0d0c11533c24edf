"""Device ops of the port: the 3x3x3 conv wrapper, grid transforms, binary
atom extraction, and the host watershed (a verbatim copy)."""
