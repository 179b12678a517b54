"""Graph synthesis, batching and padding (numpy, as in the reference)."""
