"""Training steps of the port (`repro.train` counterpart)."""
