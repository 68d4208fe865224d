"""Serving steps of the port (single device; the mesh layer is not ported)."""
