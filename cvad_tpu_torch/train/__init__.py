"""Training of the port: optimizer, state, family-D steps and the trainer."""
