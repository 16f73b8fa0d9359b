"""Host utilities of the port: logging, timers, checkpoints."""
