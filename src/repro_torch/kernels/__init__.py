"""The hand-written Hopper kernels, their plain versions and wrappers."""
