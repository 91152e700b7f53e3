"""The trainer's internals that the port has: sharded checkpoints and
their manager."""
