"""Host-side machinery around the training loop (fault tolerance)."""
