"""Geometry, NMS and the kernel wrappers (each with its plain version)."""
