"""Atomic on-disk checkpoints of the port's training state."""
