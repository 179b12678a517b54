"""Graph synthesis, batching and padding, neighbour sampling (numpy, as in
the reference), and the prefetch pipeline that moves sampled batches to
the device."""
