"""Sharding over devices (parallel/mesh.py) and its collectives."""
