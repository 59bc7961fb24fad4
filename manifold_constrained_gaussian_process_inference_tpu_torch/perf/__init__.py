"""Measurement scripts of the port; they run on a CUDA card only."""
