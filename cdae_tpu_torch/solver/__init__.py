"""Training and evaluation orchestration of the port."""
