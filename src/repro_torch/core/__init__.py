"""Ops, plans and the config space of the port."""
