"""Drivers of the timed path, one module a kind of work, named by a
traffic file's ``driver`` key. Each has ``setup(config, traffic, seed,
device, hooks) -> Session``; see :class:`bench.harness.Session`."""
