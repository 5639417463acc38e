"""Device ops of the port: the 1-D passes (core), the K1 kernel (minplus)
and the N-D composition (compose)."""
