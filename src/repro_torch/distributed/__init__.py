"""Placement rules of the execution plan's sharding column (mesh-free)."""
